// stats_mxu / seed_mxu: the block-form ("mxu") stats and seed sweeps.
//
// Replace the TPU kernels buildingsegment_tpu/ops/stats_mxu.py
// _stats_mxu_kernel (wrapper fused_stats_mxu, called from
// knn_normals_window_stats under stats_rank_mode="mxu") and
// _seed_mxu_kernel (wrapper seed_sweep_mxu, called from window_seeds
// under seg_seed_mode="mxu").
//
// They compute the TPU kernels' rounding, not the exact sweeps' (see
// ops/stats_mxu.py): per block of 128 query rows [128b, 128b + 128), the
// C = 128 + 2w candidates [128b - w, 128b + 128 + w) (outside [0, n):
// position -3e7, normal 0, mask 0) are taken about the block's origin o,
// the least coordinates of its valid candidates (0 when it has none), and
//   D = (c-o)·(-2(q-o)) + |c-o|^2 + |q-o|^2 + BIG_c + BIG_q
// is added left to right (BIG = 1e30 for an invalid row).  The library is
// built with -fmad=false, so every product and sum rounds as in the plain
// PyTorch versions, which make the same operations in the same order: the
// outputs are bit-identical to them.
//
// stats_mxu: D clamped at 0; the ranks see D + BIG outside the window and
// at self.  dk is the (k-1)-th smallest rank value (0 from 1e29's bits
// up), the hybrid cap min(r^2, (max_nn-1)-th); the ten raw block-local
// moments sum the candidates with D + (0 in the window, self included,
// else BIG) <= cap in candidate order and are converted to query-centred
// sums with the TPU kernel's expressions.
//
// seed_mxu: a query is bad when a candidate in its window (self excluded)
// with D <= dk fails |(c-o)·n_q - (q-o)·n_q| <= th or (|)n_c·n_q(|) >= cos.
//
// What bounds them on the H100: the functions compute the work of the
// exact sweeps (stats_sweep.cu, seed_sweep.cu): a squared distance and a
// few compares per (row, window candidate), moments per accepted
// neighbour; bytes are 13-32 B a row in, 4-44 B out.
//
// Design: the TPU kernels made D, the normal cosines and the moments
// matmuls on the MXU at HIGHEST precision (a bf16 split).  Here the
// arithmetic stays FP32 on the CUDA cores: TF32 or a bf16 split would
// break the exact small-span regime.  A block of 128 threads, one query
// each, stages its C candidates in shared memory, takes the origin by a
// block min-reduction (order-free), and stores each candidate's c-o,
// |c-o|^2 and BIG_c once.
//
// stats_mxu ranks and gates only the query's 2w + 1 window slots.  Every
// rank value outside the window or at self is clamp(D) + 1e30 >= 1e30,
// so a rank value below 1e29 is always a window slot's: the r-th
// smallest over the 2w window values (+inf past them) equals the r-th
// over all C whenever either is below 1e29, and both give dk = 0 and a
// cap of r^2 otherwise (while r^2 < 1e29, the wrapper's limit).  The
// moment gate (<= r_eff^2 <= r^2) passes only the 2w + 1 window slots
// for the same reason.  Per query:
//   1. one pass over the window slots in candidate order computes D,
//      feeds the 2w values to the selection (select_rank.cuh: the 16
//      smallest, kept sorted in registers), folds the moments of the
//      slots (self included) with clamp(D) <= r^2, and counts cnt_r, the
//      window values <= r^2;
//   2. dk, the r_k-th smallest, comes out of that pass for r_k <= 16;
//      larger ranks take further passes (D recomputed, not stored);
//   3. the cap binds only where cnt_r >= r_cap (else the r_cap-th value
//      exceeds r^2 and the moments of step 1 stand); such a query is
//      queued and taken by a whole warp after the block's queries: a
//      bitonic sort of its 2w <= 128 values across the warp gives the
//      cap, and ten lanes fold the moments over clamp(D) <= cap, one
//      column each, in candidate order.  Wider windows take further
//      passes and a second fold in the query's own thread.
// Order statistics are values, so any exact selection gives the ranks'
// bits (D is never -0: its last term adds +0 or 1e30).
//
// seed_mxu: each thread walks all C candidates of its block (the gate
// D + (0 in the window, else BIG) <= dk over the whole block).
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_rank.cuh"
#include "sweep_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr float kBig = 1e30f;
constexpr float kPosFill = -3e7f;
constexpr float kOriginFill = 3e7f;
constexpr int kBigCutBits = 0x6FA18F08;  // f32 1e29
using select_rank::kInf;
using select_rank::kList;

// Stage the block's C candidates' positions and validity, take the
// origin (per axis the least coordinate of the valid candidates, 0 when
// there is none) by a block min-reduction, then replace the positions by
// c - o and fill |c-o|^2 and BIG_c.  blockDim.x == kBlock.
__device__ __forceinline__ void stage_block(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ mask, int n,
    int w, int C, float* cx, float* cy, float* cz, float* cv, float* c2,
    float& ox, float& oy, float& oz) {
  __shared__ float red[3][kWarps];
  const int base = blockIdx.x * kBlock - w;
  float lx = kOriginFill, ly = kOriginFill, lz = kOriginFill;
  int any = 0;
  for (int k = threadIdx.x; k < C; k += kBlock) {
    const int r = base + k;
    const bool in = r >= 0 && r < n;
    const float x = in ? px[r] : kPosFill;
    const float y = in ? py[r] : kPosFill;
    const float z = in ? pz[r] : kPosFill;
    const bool v = in && mask[r];
    cx[k] = x;
    cy[k] = y;
    cz[k] = z;
    cv[k] = v ? 1.f : 0.f;
    if (v) {
      lx = fminf(lx, x);
      ly = fminf(ly, y);
      lz = fminf(lz, z);
      any = 1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, o));
    ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, o));
    lz = fminf(lz, __shfl_xor_sync(0xffffffffu, lz, o));
  }
  const int wid = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][wid] = lx;
    red[1][wid] = ly;
    red[2][wid] = lz;
  }
  any = __syncthreads_or(any);  // also publishes red and the raw rows
  ox = oy = oz = 0.f;
  if (any) {
    ox = fminf(fminf(red[0][0], red[0][1]), fminf(red[0][2], red[0][3]));
    oy = fminf(fminf(red[1][0], red[1][1]), fminf(red[1][2], red[1][3]));
    oz = fminf(fminf(red[2][0], red[2][1]), fminf(red[2][2], red[2][3]));
  }
  for (int k = threadIdx.x; k < C; k += kBlock) {
    const float a = cx[k] - ox, b = cy[k] - oy, d = cz[k] - oz;
    cx[k] = a;
    cy[k] = b;
    cz[k] = d;
    c2[k] = a * a + b * b + d * d;
    cv[k] = cv[k] > 0.5f ? 0.f : kBig;  // now BIG_c
  }
  __syncthreads();
}
static_assert(kWarps == 4, "stage_block joins four warps' minima");

// D of candidate c for a query with -2(q-o) = (mx, my, mz), |q-o|^2 = q2
// and BIG_q = bq, the TPU kernel's 8-term row left to right (its last
// term, 0·0, adds nothing: no partial sum after |c-o|^2 is -0).
__device__ __forceinline__ float block_distance(
    const float* cx, const float* cy, const float* cz, const float* c2,
    const float* bc, int c, float mx, float my, float mz, float q2,
    float bq) {
  float d = cx[c] * mx;
  d = d + cy[c] * my;
  d = d + cz[c] * mz;
  d = d + c2[c];
  d = d + q2;
  d = d + bc[c];
  return d + bq;
}

// One query of the staged block: its window slots' clamped D.
struct Query {
  const float *cx, *cy, *cz, *c2, *bc;
  int self, w;
  float qxo, qyo, qzo, mx, my, mz, q2, bq;

  __device__ __forceinline__ Query(const float* x, const float* y,
                                   const float* z, const float* sq,
                                   const float* big, int t, int w_)
      : cx(x), cy(y), cz(z), c2(sq), bc(big), self(w_ + t), w(w_) {
    qxo = cx[self];
    qyo = cy[self];
    qzo = cz[self];
    mx = -2.f * qxo;
    my = -2.f * qyo;
    mz = -2.f * qzo;
    q2 = c2[self];
    bq = bc[self];
  }

  // clamp(D) of candidate c (the plain version's clamp_min(D, 0))
  __device__ __forceinline__ float value(int c) const {
    return fmaxf(block_distance(cx, cy, cz, c2, bc, c, mx, my, mz, q2, bq),
                 0.f);
  }

  // the candidate of rank slot s in [0, 2w): offsets -w..-1, then +1..+w
  __device__ __forceinline__ int slot(int s) const {
    return self + (s < w ? s - w : s - w + 1);
  }
};

// The raw block-local moments, added in candidate order from +0.
struct Moments {
  float m[10];

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int j = 0; j < 10; ++j) m[j] = 0.f;
  }

  __device__ __forceinline__ void add(float a, float b, float e) {
    m[0] += 1.f;
    m[1] += a;
    m[2] += b;
    m[3] += e;
    m[4] += a * a;
    m[5] += b * b;
    m[6] += e * e;
    m[7] += a * b;
    m[8] += a * e;
    m[9] += b * e;
  }
};

// The moments converted to query-centred sums (the TPU kernel's
// expressions), rows 1-10 of column i.
__device__ __forceinline__ void write_moments(const float (&m)[10],
                                              float qxo, float qyo,
                                              float qzo, float* out, int n,
                                              int i) {
  const float m0 = m[0];
  out[1 * n + i] = m0;
  out[2 * n + i] = m[1] - m0 * qxo;
  out[3 * n + i] = m[2] - m0 * qyo;
  out[4 * n + i] = m[3] - m0 * qzo;
  out[5 * n + i] = m[4] - 2.f * qxo * m[1] + m0 * qxo * qxo;
  out[6 * n + i] = m[5] - 2.f * qyo * m[2] + m0 * qyo * qyo;
  out[7 * n + i] = m[6] - 2.f * qzo * m[3] + m0 * qzo * qzo;
  out[8 * n + i] = m[7] - qxo * m[2] - qyo * m[1] + m0 * qxo * qyo;
  out[9 * n + i] = m[8] - qxo * m[3] - qzo * m[1] + m0 * qxo * qzo;
  out[10 * n + i] = m[9] - qyo * m[3] - qzo * m[2] + m0 * qyo * qzo;
}

constexpr int kWarpSlots = 128;  // widest 2w of the warp cap path: 4 a lane
constexpr int kTerms = 10;       // moment columns
constexpr int kTermStride = kTerms + 1;

// A query whose cap binds, by one warp: its cap from a sort of its
// 2w <= 128 window values across the warp, then its moments over
// clamp(D) <= min(r^2, cap) with one lane a column, each column a left
// fold in candidate order over rounds of 32 of the 2w + 1 slots staged
// in the warp's scratch (a slot outside the gate stages +0 terms, which
// leave a fold from +0 unchanged).
__device__ __forceinline__ void cap_query_by_warp(const Query& q, int r_cap,
                                                  float r2, float* scr,
                                                  float* out, int n, int i) {
  const int lane = threadIdx.x & 31;
  const int w2 = 2 * q.w;
  float key[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = 4 * lane + r;
    key[r] = s < w2 ? q.value(q.slot(s)) : kInf;
  }
  const float r_eff2 = fminf(r2, select_rank::warp_pick(key, r_cap - 1));
  float acc = 0.f;  // column `lane`
  float* mine = scr + lane * kTermStride;
  const int c0 = q.self - q.w;
  for (int s0 = 0; s0 <= w2; s0 += 32) {
    const int s = s0 + lane;
    const bool use = s <= w2 && q.value(c0 + s) <= r_eff2;
    const float a = use ? q.cx[c0 + s] : 0.f;
    const float b = use ? q.cy[c0 + s] : 0.f;
    const float e = use ? q.cz[c0 + s] : 0.f;
    mine[0] = use ? 1.f : 0.f;
    mine[1] = a;
    mine[2] = b;
    mine[3] = e;
    mine[4] = a * a;
    mine[5] = b * b;
    mine[6] = e * e;
    mine[7] = a * b;
    mine[8] = a * e;
    mine[9] = b * e;
    __syncwarp();
    if (lane < kTerms) {
      const int cnt = min(32, w2 + 1 - s0);
      for (int j = 0; j < cnt; ++j) acc += scr[j * kTermStride + lane];
    }
    __syncwarp();
  }
  float m[10];
#pragma unroll
  for (int j = 0; j < kTerms; ++j) m[j] = __shfl_sync(0xffffffffu, acc, j);
  if (lane == 0) write_moments(m, q.qxo, q.qyo, q.qzo, out, n, i);
}

__global__ void __launch_bounds__(kBlock, 6) stats_mxu_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int n, int w, int r_k, int r_cap, float r2) {
  extern __shared__ float sm[];
  __shared__ float scratch[kWarps][32 * kTermStride];
  __shared__ int capq[kBlock];  // queries whose cap binds, for the warps
  __shared__ int ncap;
  const int C = kBlock + 2 * w;
  float* cx = sm;
  float* cy = cx + C;
  float* cz = cy + C;
  float* bc = cz + C;
  float* c2 = bc + C;
  if (threadIdx.x == 0) ncap = 0;  // published by stage_block's barriers
  float ox, oy, oz;
  stage_block(px, py, pz, mask, n, w, C, cx, cy, cz, bc, c2, ox, oy, oz);

  const int t = threadIdx.x;
  const int i = blockIdx.x * kBlock + t;
  const int w2 = 2 * w;
  const bool warp_cap = w2 <= kWarpSlots;
  if (i < n) {
    const Query q(cx, cy, cz, c2, bc, t, w);

    // 1. the first selection pass, the moments within r^2 (self between
    // the slots of offsets -1 and +1), cnt_r
    select_rank::Passes ps;
    ps.start_first();
    Moments m;
    m.start();
    int cnt_r = 0;
    for (int s0 = 0; s0 < w2; s0 += kList) {
#pragma unroll
      for (int u = 0; u < kList; ++u) {
        const int s = s0 + u;
        if (s == w && q.value(q.self) <= r2) m.add(q.qxo, q.qyo, q.qzo);
        float v = kInf;
        if (s < w2) {
          const int c = q.slot(s);
          v = q.value(c);
          if (v <= r2) {
            ++cnt_r;
            m.add(cx[c], cy[c], cz[c]);
          }
        }
        ps.put_first(u, v);
      }
      ps.end_chunk();
    }
    ps.end_pass(true);

    // 2-3. the ranks this thread selects: r_k (0: none; past the 2w
    // window values: +inf), r_cap where the cap binds and the warp path
    // does not take the query
    const bool binds = r_cap > 0 && cnt_r >= r_cap;
    float dk = kInf, cap = kInf;
    bool dk_done = r_k <= 0 || r_k > w2 || ps.settle(r_k, dk);
    bool cap_done = !binds || warp_cap || ps.settle(r_cap, cap);
    while (!(dk_done && cap_done)) {
      ps.next_pass();
      for (int s0 = 0; s0 < w2; s0 += kList) {
#pragma unroll
        for (int u = 0; u < kList; ++u) {
          const int s = s0 + u;
          ps.put(u, s < w2 ? q.value(q.slot(s)) : kInf);
        }
        ps.end_chunk();
      }
      ps.end_pass(false);
      if (!dk_done) dk_done = ps.settle(r_k, dk);
      if (!cap_done) cap_done = ps.settle(r_cap, cap);
    }
    // a rank value at or above 1e29's bits (+inf included) is a mask
    // payload: dk = 0
    out[i] = __float_as_int(dk) >= kBigCutBits ? 0.f : dk;

    if (binds && warp_cap) {
      capq[atomicAdd(&ncap, 1)] = t;
    } else {
      if (binds) {  // the moments again, over clamp(D) <= min(r^2, cap)
        const float r_eff2 = fminf(r2, cap);
        m.start();
        for (int c = q.self - w; c <= q.self + w; ++c)
          if (q.value(c) <= r_eff2) m.add(cx[c], cy[c], cz[c]);
      }
      write_moments(m.m, q.qxo, q.qyo, q.qzo, out, n, i);
    }
  }
  // 3. the queries whose cap binds, a warp each (in any order: each
  // query's result is its own)
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int e = warp; e < ncap; e += kWarps) {
    const int tq = capq[e];
    cap_query_by_warp(Query(cx, cy, cz, c2, bc, tq, w), r_cap, r2,
                      scratch[warp], out, n, blockIdx.x * kBlock + tq);
  }
}

__global__ void seed_mxu_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const uint8_t* __restrict__ mask, const float* __restrict__ dk,
    uint8_t* __restrict__ seed, int n, int w, float th, float cth,
    int sgn) {
  extern __shared__ float sm[];
  const int C = kBlock + 2 * w;
  float* cx = sm;
  float* cy = cx + C;
  float* cz = cy + C;
  float* bc = cz + C;
  float* c2 = bc + C;
  float* cnx = c2 + C;
  float* cny = cnx + C;
  float* cnz = cny + C;
  const int base = blockIdx.x * kBlock - w;
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    const int r = base + k;
    const bool in = r >= 0 && r < n;
    cnx[k] = in ? nx[r] : 0.f;
    cny[k] = in ? ny[r] : 0.f;
    cnz[k] = in ? nz[r] : 0.f;
  }
  float ox, oy, oz;
  stage_block(px, py, pz, mask, n, w, C, cx, cy, cz, bc, c2, ox, oy, oz);

  const int t = threadIdx.x;
  const int i = blockIdx.x * kBlock + t;
  if (i >= n) return;
  const int self = w + t;
  const float qxo = cx[self], qyo = cy[self], qzo = cz[self];
  const float qnx = cnx[self], qny = cny[self], qnz = cnz[self];
  const float bq = bc[self];
  const float mx = -2.f * qxo, my = -2.f * qyo, mz = -2.f * qzo;
  const float q2 = c2[self];
  const float ball = dk[i];
  const float qdotn = qxo * qnx + qyo * qny + qzo * qnz;
  bool bad = false;
  for (int c = 0; c < C; ++c) {
    const int off = c - self;
    const float win = (off >= -w && off <= w && off != 0) ? 0.f : kBig;
    const float d = block_distance(cx, cy, cz, c2, bc, c, mx, my, mz, q2, bq);
    if (!(d + win <= ball)) continue;
    const float cn = cnx[c] * qnx + cny[c] * qny + cnz[c] * qnz;
    const float cp = cx[c] * qnx + cy[c] * qny + cz[c] * qnz;
    const float pd = fabsf(cp - qdotn);
    if (!(pd <= th && cmag(cn, sgn) >= cth)) {
      bad = true;
      break;
    }
  }
  seed[i] = mask[i] != 0 && !bad;
}

}  // namespace

extern "C" {

int bst_stats_mxu(const float* px, const float* py, const float* pz,
                  const uint8_t* mask, float* out, int n, int w, int r_k,
                  int r_cap, float r2, void* stream) {
  if (n <= 0 || w < 1) return cudaErrorInvalidValue;
  const int C = kBlock + 2 * w;
  const int smem = 5 * C * 4;
  cudaFuncSetAttribute(stats_mxu_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stats_mxu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, mask, out, n, w, r_k, r_cap, r2);
  return static_cast<int>(cudaGetLastError());
}

int bst_seed_mxu(const float* px, const float* py, const float* pz,
                 const float* nx, const float* ny, const float* nz,
                 const uint8_t* mask, const float* dk, uint8_t* seed, int n,
                 int w, float th, float cth, int sgn, void* stream) {
  if (n <= 0 || w < 1) return cudaErrorInvalidValue;
  const int C = kBlock + 2 * w;
  const int smem = 8 * C * 4;
  cudaFuncSetAttribute(seed_mxu_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  seed_mxu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, nx, ny, nz, mask, dk, seed, n, w, th, cth, sgn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
