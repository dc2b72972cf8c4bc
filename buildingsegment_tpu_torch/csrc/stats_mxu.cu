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
// neighbour; bytes are 13-32 B a row in, 4-44 B out.  These designs spend
// more.  Each thread owns one query and evaluates all C candidates of its
// block (C = 224 at w = 48, 160 at w = 16), not only its 2w + 1, because
// the block form defines the ranks and the gate over the whole block; the
// stats kernel then selects both ranks by a 31-step bisection over the
// bit patterns of its C values, about 14,000 shared-memory compares a row
// (select_rank.cuh, which stats_sweep.cu uses, selects with far fewer),
// with one 128-thread block per SM (its [C][128] rank array takes
// 112 KB).
//
// Design: the TPU kernels made D, the normal cosines and the moments
// matmuls on the MXU at HIGHEST precision (a bf16 split).  Here the
// arithmetic stays FP32 on the CUDA cores: TF32 or a bf16 split would
// break the exact small-span regime.  A block of 128 threads stages its
// candidates in shared memory, every thread takes the origin by the same
// min-scan over them (order-free), the block stores each candidate's
// c-o, |c-o|^2 and BIG_c once, and each thread walks the candidates in
// order.  A 3xTF32 wgmma form is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr float kBig = 1e30f;
constexpr float kPosFill = -3e7f;
constexpr float kOriginFill = 3e7f;
constexpr int kInfBits = 0x7F800000;
constexpr int kBigCutBits = 0x6FA18F08;  // f32 1e29

// Stage the block's C candidates' positions and validity, then replace
// the positions by c - o and fill |c-o|^2 and BIG_c.  Returns the origin.
__device__ __forceinline__ void stage_block(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ mask, int n,
    int w, int C, float* cx, float* cy, float* cz, float* cv, float* c2,
    float& ox, float& oy, float& oz) {
  const int base = blockIdx.x * kBlock - w;
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    const int r = base + k;
    const bool in = r >= 0 && r < n;
    cx[k] = in ? px[r] : kPosFill;
    cy[k] = in ? py[r] : kPosFill;
    cz[k] = in ? pz[r] : kPosFill;
    cv[k] = (in && mask[r]) ? 1.f : 0.f;
  }
  __syncthreads();
  ox = kOriginFill;
  oy = kOriginFill;
  oz = kOriginFill;
  bool any = false;
  for (int c = 0; c < C; ++c) {
    if (cv[c] > 0.5f) {
      ox = fminf(ox, cx[c]);
      oy = fminf(oy, cy[c]);
      oz = fminf(oz, cz[c]);
      any = true;
    }
  }
  if (!any) ox = oy = oz = 0.f;
  __syncthreads();  // every thread has read the raw positions
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    const float a = cx[k] - ox, b = cy[k] - oy, d = cz[k] - oz;
    cx[k] = a;
    cy[k] = b;
    cz[k] = d;
    c2[k] = a * a + b * b + d * d;
    cv[k] = cv[k] > 0.5f ? 0.f : kBig;  // now BIG_c
  }
  __syncthreads();
}

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

__global__ void stats_mxu_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int n, int w, int r_k, int r_cap, float r2) {
  extern __shared__ float sm[];
  const int C = kBlock + 2 * w;
  float* cx = sm;
  float* cy = cx + C;
  float* cz = cy + C;
  float* bc = cz + C;
  float* c2 = bc + C;
  int* db = reinterpret_cast<int*>(c2 + C);  // [C][kBlock] rank bits
  float ox, oy, oz;
  stage_block(px, py, pz, mask, n, w, C, cx, cy, cz, bc, c2, ox, oy, oz);

  const int t = threadIdx.x;
  const int i = blockIdx.x * kBlock + t;
  const int self = w + t;
  const float qxo = cx[self], qyo = cy[self], qzo = cz[self];
  const float bq = bc[self];  // the query's own validity
  const float mx = -2.f * qxo, my = -2.f * qyo, mz = -2.f * qzo;
  const float q2 = c2[self];

  // phase 1: the rank column (D + BIG outside the window and at self)
  float d_self = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d = fmaxf(
        block_distance(cx, cy, cz, c2, bc, c, mx, my, mz, q2, bq), 0.f);
    const int off = c - self;
    const bool ranked = off >= -w && off <= w && off != 0;
    if (off == 0) d_self = d;
    db[c * kBlock + t] = __float_as_int(ranked ? d : d + kBig);
  }

  // phase 2: the smallest bit pattern with count(bits <= it) >= r, for
  // r = r_k and r = r_cap, in one 31-step bisection (exact r-th smallest)
  int lo1 = 0, hi1 = kInfBits, lo2 = 0, hi2 = kInfBits;
  for (int it = 0; it < 31; ++it) {
    const int mid1 = lo1 + ((hi1 - lo1) >> 1);
    const int mid2 = lo2 + ((hi2 - lo2) >> 1);
    int n1 = 0, n2 = 0;
    for (int c = 0; c < C; ++c) {
      const int b = db[c * kBlock + t];
      n1 += b <= mid1;
      n2 += b <= mid2;
    }
    if (n1 >= r_k) hi1 = mid1; else lo1 = mid1 + 1;
    if (n2 >= r_cap) hi2 = mid2; else lo2 = mid2 + 1;
  }
  const float dk = (r_k == 0 || lo1 >= kBigCutBits) ? 0.f
                                                    : __int_as_float(lo1);
  const float r_eff2 = r_cap > 0 ? fminf(r2, __int_as_float(lo2)) : r2;

  // phase 3: raw block-local moments in candidate order; the gate value
  // equals the rank value except at self (D + 0)
  float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f, m4 = 0.f, m5 = 0.f;
  float m6 = 0.f, m7 = 0.f, m8 = 0.f, m9 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float g = c == self ? d_self : __int_as_float(db[c * kBlock + t]);
    if (!(g <= r_eff2)) continue;
    const float a = cx[c], b = cy[c], e = cz[c];
    m0 += 1.f;
    m1 += a;
    m2 += b;
    m3 += e;
    m4 += a * a;
    m5 += b * b;
    m6 += e * e;
    m7 += a * b;
    m8 += a * e;
    m9 += b * e;
  }
  if (i >= n) return;
  const float sxx = m4 - 2.f * qxo * m1 + m0 * qxo * qxo;
  const float syy = m5 - 2.f * qyo * m2 + m0 * qyo * qyo;
  const float szz = m6 - 2.f * qzo * m3 + m0 * qzo * qzo;
  const float sxy = m7 - qxo * m2 - qyo * m1 + m0 * qxo * qyo;
  const float sxz = m8 - qxo * m3 - qzo * m1 + m0 * qxo * qzo;
  const float syz = m9 - qyo * m3 - qzo * m2 + m0 * qyo * qzo;
  out[i] = dk;
  out[1 * n + i] = m0;
  out[2 * n + i] = m1 - m0 * qxo;
  out[3 * n + i] = m2 - m0 * qyo;
  out[4 * n + i] = m3 - m0 * qzo;
  out[5 * n + i] = sxx;
  out[6 * n + i] = syy;
  out[7 * n + i] = szz;
  out[8 * n + i] = sxy;
  out[9 * n + i] = sxz;
  out[10 * n + i] = syz;
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
  const int smem = (5 * C + C * kBlock) * 4;
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
