// compact_sweep: one whole solver sweep of the window region growing in
// compact slot space (slot ids 0..lc-1, lc = "no label").
//
// Replaces the TPU kernel buildingsegment_tpu/ops/compact_sweep.py
// _compact_kernel (wrapper compact_sweep, one pallas_call grid step).
//
// What bounds it on the H100: latency, not bandwidth or arithmetic.  A
// sweep reads the ~223k-row problem a few times (~20 MB) and runs at
// most lc^2 = 4M pair tests (~0.2 GFLOP); each phase is microseconds of
// device time, so the launch chain and the serial per-slot sums set the
// cost.
//
// Design: the TPU ran the sweep as one grid step over the VMEM-resident
// problem, with every scatter and gather written as a one-hot matmul.
// Blocks on Hopper run in parallel with nothing carried between them, so
// the sweep is a fixed chain of launches on one stream, with direct
// gathers and integer atomics:
//   1. stats_partial: per-slot [cnt, sum n^, sum p, sum |p|^2] for all
//      members and anchor-pure members, one partial table per block of
//      kStatsRows rows, summed sequentially in row order (block b covers
//      rows [b*kStatsRows - w, (b+1)*kStatsRows - w), the TPU kernel's
//      column blocks of the w-padded slab);
//   2. reduce_models: the partial tables summed in block order (a fixed
//      order, so the sums and num_sweeps do not change from run to run),
//      then the model refresh (acc_models semantics, pure-count fallback)
//      and parent[s] = s;
//   3. hop: the +-w hop/merge pass with the [bound, 6] model table in
//      shared memory (a plain gather in place of the one-hot matmul); the
//      merge hook is a segment-min by slot with int atomicMin (exact);
//   4. pairs: the [bound, bound] coplanar-overlap tests, min per column;
//   5. jump: the jump rounds over [lc] in one block, double-buffered so
//      every round reads the previous round's table (synchronous, as the
//      TPU kernel's rounds are), with the same `covered` guard;
//   6. apply: the collapsed parents applied to the hop result, with the
//      change count and the largest surviving slot by int atomics.
#include "sweep_common.cuh"

namespace {

constexpr int kStatsRows = 1024;

__global__ void stats_partial_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ cnx,
    const float* __restrict__ cny, const float* __restrict__ cnz,
    const int* __restrict__ clab, const float* __restrict__ anchor,
    float* __restrict__ partial, uint8_t* __restrict__ touched, int n,
    int w, int lc, int bound, float thac, int anchor_gate, int sgn) {
  extern __shared__ float smem[];
  float* tab = smem;                                         // [bound][16]
  uint8_t* tch = reinterpret_cast<uint8_t*>(tab + bound * 16);  // [bound]
  const int b = blockIdx.x;
  const int lane = threadIdx.x;  // one warp
  for (int k = lane; k < bound * 16; k += 32) tab[k] = 0.f;
  for (int k = lane; k < bound; k += 32) tch[k] = 0;
  __syncthreads();
  const int r0 = max(b * kStatsRows - w, 0);
  const int r1 = min(b * kStatsRows - w + kStatsRows, n);
  if (lane < 16) {
    // column `lane` of the 16-wide payload; consecutive rows of one slot
    // accumulate in a register, which keeps the sum strictly sequential
    // in row order (tab[s] + v_0 + v_1 + ...) without a shared-memory
    // round trip per row
    const int col = lane & 7;
    const bool pure_col = lane >= 8;
    int cur = -1;
    float acc = 0.f;
    for (int r = r0; r < r1; ++r) {
      const int s = clab[r];
      if (s >= bound) continue;  // no label (every live slot < bound)
      const float x = px[r], y = py[r], z = pz[r];
      const float cx = cnx[r], cy = cny[r], cz = cnz[r];
      float v;
      switch (col) {
        case 0: v = 1.f; break;
        case 1: v = cx; break;
        case 2: v = cy; break;
        case 3: v = cz; break;
        case 4: v = x; break;
        case 5: v = y; break;
        case 6: v = z; break;
        default: v = x * x + y * y + z * z; break;
      }
      if (pure_col) {
        bool pure = false;
        if (anchor_gate) {
          const float* a = anchor + 3 * s;
          pure = cmag(cx * a[0] + cy * a[1] + cz * a[2], sgn) >= thac;
        }
        if (!pure) v = 0.f;
      }
      if (s != cur) {
        if (cur >= 0) tab[cur * 16 + lane] = acc;
        cur = s;
        acc = tab[s * 16 + lane];
        if (lane == 0) tch[s] = 1;
      }
      acc += v;
    }
    if (cur >= 0) tab[cur * 16 + lane] = acc;
  }
  __syncthreads();
  uint8_t* tflag = touched + static_cast<size_t>(b) * lc;
  float* part = partial + static_cast<size_t>(b) * lc * 16;
  for (int s = lane; s < bound; s += 32) tflag[s] = tch[s];
  for (int k = lane; k < bound * 16; k += 32) {
    if (tch[k >> 4]) part[k] = tab[k];
  }
}

__global__ void reduce_models_kernel(
    const float* __restrict__ partial, const uint8_t* __restrict__ touched,
    float* __restrict__ mtab, float* __restrict__ ptab,
    int* __restrict__ parent, int nblk, int lc, int bound, int anchor_gate) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= lc) return;
  float a[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) a[c] = 0.f;
  if (s < bound) {
    for (int b = 0; b < nblk; ++b) {
      const size_t k = static_cast<size_t>(b) * lc + s;
      if (!touched[k]) continue;
      const float* p = partial + k * 16;
#pragma unroll
      for (int c = 0; c < 16; ++c) a[c] += p[c];
    }
  }
  const float cnt = a[0];
  float sc, sn0, sn1, sn2, c0, c1, c2, sqm;
  if (anchor_gate) {
    const bool usep = a[8] > 0.f;
    sc = usep ? a[8] : fmaxf(cnt, 1.f);
    sn0 = (usep ? a[9] : a[1]) / sc;
    sn1 = (usep ? a[10] : a[2]) / sc;
    sn2 = (usep ? a[11] : a[3]) / sc;
    c0 = (usep ? a[12] : a[4]) / sc;
    c1 = (usep ? a[13] : a[5]) / sc;
    c2 = (usep ? a[14] : a[6]) / sc;
    sqm = (usep ? a[15] : a[7]) / sc;
  } else {
    sc = fmaxf(cnt, 1.f);
    sn0 = a[1] / sc;
    sn1 = a[2] / sc;
    sn2 = a[3] / sc;
    c0 = a[4] / sc;
    c1 = a[5] / sc;
    c2 = a[6] / sc;
    sqm = a[7] / sc;
  }
  const float ln = sqrtf(fmaxf(sn0 * sn0 + sn1 * sn1 + sn2 * sn2, 1e-20f));
  const float m0 = sn0 / ln, m1 = sn1 / ln, m2 = sn2 / ln;
  const float reach =
      2.f * sqrtf(fmaxf(sqm - (c0 * c0 + c1 * c1 + c2 * c2), 0.f));
  float* mt = mtab + 6 * s;
  mt[0] = m0; mt[1] = m1; mt[2] = m2;
  mt[3] = c0; mt[4] = c1; mt[5] = c2;
  float* pt = ptab + 10 * s;
  pt[0] = m0; pt[1] = m1; pt[2] = m2;
  pt[3] = c0; pt[4] = c1; pt[5] = c2;
  pt[6] = reach;
  pt[7] = cnt;
  pt[8] = m0 * c0 + m1 * c1 + m2 * c2;  // n_s . c_s
  pt[9] = c0 * c0 + c1 * c1 + c2 * c2;  // |c_s|^2
  parent[s] = s;
}

__global__ void hop_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const uint8_t* __restrict__ mask, const int* __restrict__ clab,
    const float* __restrict__ mtab, int* __restrict__ hop,
    int* __restrict__ parent, int n, int w, int bound, WindowParams p) {
  extern __shared__ float sm[];  // [bound][6] model table
  for (int k = threadIdx.x; k < bound * 6; k += blockDim.x) sm[k] = mtab[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lab0 = clab[i];
  const bool has = lab0 < p.inf;
  const float* om = sm + 6 * lab0;
  const bool own = lab0 < bound;
  RowModel r{px[i], py[i], pz[i], nx[i], ny[i], nz[i],
             own ? om[0] : 0.f, own ? om[1] : 0.f, own ? om[2] : 0.f,
             own ? om[3] : 0.f, own ? om[4] : 0.f, own ? om[5] : 0.f};
  int nw = lab0;
  int best = p.inf;
  if (mask[i]) {
    for (int slot = 0; slot < 2 * w; ++slot) {
      const int j = i + (slot < w ? slot - w : slot - w + 1);
      if (j < 0 || j >= n || !mask[j]) continue;
      if (!window_near(r, px[j], py[j], pz[j], p.eg2)) continue;
      const int cl = clab[j];
      const bool cm = cl < bound;
      const float* c = sm + 6 * cl;
      window_candidate(r, lab0, has, cl, cm ? c[0] : 0.f, cm ? c[1] : 0.f,
                       cm ? c[2] : 0.f, cm ? c[3] : 0.f, cm ? c[4] : 0.f,
                       cm ? c[5] : 0.f, p, nw, best);
    }
  }
  hop[i] = nw;
  if (best < p.inf) atomicMin(parent + lab0, best);
}

__global__ void pairs_kernel(const float* __restrict__ ptab,
                             int* __restrict__ parent, int bound,
                             WindowParams p, float root_gate) {
  __shared__ float tile[128 * 10];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float bj[10];
  const bool live_j = j < bound;
#pragma unroll
  for (int c = 0; c < 10; ++c) bj[c] = live_j ? ptab[10 * j + c] : 0.f;
  const bool cnt_j = live_j && bj[7] > 0.f;
  int colmin = p.inf;
  for (int t0 = 0; t0 < bound; t0 += 128) {
    const int rows = min(128, bound - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < rows * 10; k += blockDim.x)
      tile[k] = ptab[10 * t0 + k];
    __syncthreads();
    if (!cnt_j) continue;
    for (int ii = 0; ii < rows; ++ii) {
      const float* a = tile + 10 * ii;  // row i: the partner of column j
      if (!(a[7] > 0.f)) continue;
      const int i = t0 + ii;
      // c_i . n_j, n_i . c_j, n_i . n_j, c_i . c_j
      const float nc_ij = a[3] * bj[0] + a[4] * bj[1] + a[5] * bj[2];
      const float cn_ij = a[0] * bj[3] + a[1] * bj[4] + a[2] * bj[5];
      const float nn_ij = a[0] * bj[0] + a[1] * bj[1] + a[2] * bj[2];
      const float cc_ij = a[3] * bj[3] + a[4] * bj[4] + a[5] * bj[5];
      const float nrm_sep = nc_ij - bj[8];    // (c_i - c_j) . n_j
      const float nrm_sep_b = a[8] - cn_ij;   // (c_i - c_j) . n_i
      const float cosab = cmag(nn_ij, p.sgn);
      const float d2 = a[9] + bj[9] - 2.f * cc_ij;
      const float inplane2 = fmaxf(d2 - nrm_sep * nrm_sep, 0.f);
      const float reach = a[6] + bj[6] + root_gate;
      const bool ok = fabsf(nrm_sep) <= p.th && fabsf(nrm_sep_b) <= p.th &&
                      cosab >= p.cth && inplane2 <= reach * reach;
      if (ok && i != j) colmin = min(colmin, min(i, j));
    }
  }
  if (live_j && colmin < parent[j]) parent[j] = colmin;
}

__global__ void jump_kernel(int* __restrict__ parent, int lc, int bound,
                            int rounds) {
  extern __shared__ int buf[];  // two [lc] tables
  int* src = buf;
  int* dst = buf + lc;
  for (int s = threadIdx.x; s < lc; s += blockDim.x) src[s] = parent[s];
  __syncthreads();
  // a chain can only read slots below the live-chunk cover (128-slot
  // chunks, as the TPU kernel's one-hot rounds)
  const int cover = (bound + 127) / 128 * 128;
  for (int r = 0; r < rounds; ++r) {
    for (int s = threadIdx.x; s < lc; s += blockDim.x) {
      const int q = src[s];
      dst[s] = min(q, q < cover ? src[q] : q);
    }
    __syncthreads();
    int* t = src;
    src = dst;
    dst = t;
  }
  for (int s = threadIdx.x; s < lc; s += blockDim.x) parent[s] = src[s];
}

__global__ void apply_kernel(const int* __restrict__ hop,
                             const int* __restrict__ clab,
                             const int* __restrict__ parent,
                             int* __restrict__ out, int* __restrict__ counters,
                             int n, int lc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int changed = 0, top = 0;
  if (i < n) {
    const int nw = hop[i];
    const int fin = nw < lc ? parent[nw] : nw;
    out[i] = fin;
    changed = fin != clab[i];
    top = fin < lc ? fin : 0;
  }
  changed = __reduce_add_sync(0xffffffffu, changed);
  top = __reduce_max_sync(0xffffffffu, top);
  if ((threadIdx.x & 31) == 0) {
    if (changed) atomicAdd(counters, changed);
    atomicMax(counters + 1, top);
  }
}

}  // namespace

extern "C" int bst_compact_sweep(
    const float* px, const float* py, const float* pz, const float* nx,
    const float* ny, const float* nz, const float* cnx, const float* cny,
    const float* cnz, const uint8_t* mask, const int* clab,
    const float* anchor, float* partial, uint8_t* touched, float* mtab,
    float* ptab, int* parent, int* hop, int* out, int* counters, int n,
    int w, int lc, int bound, float th, float cth, float eg2, float thac,
    float root_gate, int anchor_gate, int sgn, int jump_rounds,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || bound < 1 || bound > lc) return cudaErrorInvalidValue;
  WindowParams p{th, cth, eg2, lc, sgn};
  const int smem_stats = bound * 16 * 4 + bound;
  const int smem_hop = bound * 6 * 4;
  const int smem_jump = 2 * lc * 4;
  cudaFuncSetAttribute(stats_partial_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_stats);
  cudaFuncSetAttribute(hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_hop);
  cudaFuncSetAttribute(jump_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_jump);
  cudaMemsetAsync(counters, 0, 2 * sizeof(int), stream);
  const int nblk = (n + w + kStatsRows - 1) / kStatsRows;
  stats_partial_kernel<<<nblk, 32, smem_stats, stream>>>(
      px, py, pz, cnx, cny, cnz, clab, anchor, partial, touched, n, w, lc,
      bound, thac, anchor_gate, sgn);
  reduce_models_kernel<<<(lc + 127) / 128, 128, 0, stream>>>(
      partial, touched, mtab, ptab, parent, nblk, lc, bound, anchor_gate);
  const int rows_blocks = (n + 255) / 256;
  hop_kernel<<<rows_blocks, 256, smem_hop, stream>>>(
      px, py, pz, nx, ny, nz, mask, clab, mtab, hop, parent, n, w, bound, p);
  pairs_kernel<<<(bound + 127) / 128, 128, 0, stream>>>(ptab, parent, bound,
                                                        p, root_gate);
  jump_kernel<<<1, 1024, smem_jump, stream>>>(parent, lc, bound, jump_rounds);
  apply_kernel<<<rows_blocks, 256, 0, stream>>>(hop, clab, parent, out,
                                                counters, n, lc);
  return static_cast<int>(cudaGetLastError());
}
