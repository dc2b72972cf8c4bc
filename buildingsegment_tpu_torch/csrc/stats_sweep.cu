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
// two for each of its 2w candidates (96 at w = 48).  This design spends
// far more: its two exact order statistics take 31 bisection steps, each
// counting the 2w candidates below two pivots, about 6,000 integer
// compares a row, all on shared memory.  A selection that looks at each
// candidate a few times would close most of that gap.
//
// Design: the TPU kernel DMA'd a padded slab per tile and bisected over a
// [2w, tile] block of distance bit patterns in VMEM.  Here a block of
// kRows threads stages the positions and mask of rows
// [b*kRows - w, (b+1)*kRows + w) in shared memory; each thread writes its
// 2w squared distances as int32 bit patterns (+inf for an invalid
// candidate; non-negative floats order as their bit patterns) into a
// slot-major [2w][kRows] array, so the 32 threads of a warp read 32
// consecutive words (no bank conflicts).  Both ranks share one bisection
// loop.  The moments then accumulate in slot order (offsets -w..-1, then
// +1..+w), re-deriving the offsets from the staged positions.  The
// library is built with -fmad=false, so every product and sum rounds as
// in the plain PyTorch version: dk and the moments are bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;
constexpr int kInfBits = 0x7F800000;

__global__ void stats_sweep_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int n, int w, int r_k, int r_cap, float r2) {
  extern __shared__ float sm[];
  const int span = kRows + 2 * w;
  float* sx = sm;
  float* sy = sx + span;
  float* sz = sy + span;
  float* sv = sz + span;                           // mask as 1 / 0
  int* db = reinterpret_cast<int*>(sv + span);     // [2w][kRows]
  const int base = blockIdx.x * kRows - w;
  for (int k = threadIdx.x; k < span; k += blockDim.x) {
    const int r = base + k;
    const bool in = r >= 0 && r < n;
    sx[k] = in ? px[r] : 0.f;
    sy[k] = in ? py[r] : 0.f;
    sz[k] = in ? pz[r] : 0.f;
    sv[k] = (in && mask[r]) ? 1.f : 0.f;
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int i = blockIdx.x * kRows + t;
  if (i >= n) return;
  const int c = t + w;  // the query's staged row
  const float qx = sx[c], qy = sy[c], qz = sz[c];
  const bool qm = sv[c] > 0.5f;
  const int w2 = 2 * w;

  // phase 1: the squared-distance row (invalid -> +inf)
  for (int s = 0; s < w2; ++s) {
    const int j = c + (s < w ? s - w : s - w + 1);
    const float dx = sx[j] - qx;
    const float dy = sy[j] - qy;
    const float dz = sz[j] - qz;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool valid = qm && sv[j] > 0.5f;
    db[s * kRows + t] = valid ? __float_as_int(d2) : kInfBits;
  }

  // phase 2: the smallest bit pattern t with count(bits <= t) >= r, for
  // r = r_k and r = r_cap, in one 31-step bisection
  int lo1 = 0, hi1 = kInfBits, lo2 = 0, hi2 = kInfBits;
  for (int it = 0; it < 31; ++it) {
    const int mid1 = lo1 + ((hi1 - lo1) >> 1);
    const int mid2 = lo2 + ((hi2 - lo2) >> 1);
    int c1 = 0, c2 = 0;
    for (int s = 0; s < w2; ++s) {
      const int b = db[s * kRows + t];
      c1 += b <= mid1;
      c2 += b <= mid2;
    }
    if (c1 >= r_k) hi1 = mid1; else lo1 = mid1 + 1;
    if (c2 >= r_cap) hi2 = mid2; else lo2 = mid2 + 1;
  }
  // fewer than r_k finite candidates -> 0 (the kNN path's convention)
  out[i] = (lo1 >= kInfBits || !qm) ? 0.f : __int_as_float(lo1);
  const float r_eff2 = r_cap > 0 ? fminf(r2, __int_as_float(lo2)) : r2;

  // phase 3: moments over radius and cap, in slot order (self: count 1)
  float s0 = qm ? 1.f : 0.f;
  float s1x = 0.f, s1y = 0.f, s1z = 0.f;
  float sxx = 0.f, syy = 0.f, szz = 0.f, sxy = 0.f, sxz = 0.f, syz = 0.f;
  for (int s = 0; s < w2; ++s) {
    if (!(__int_as_float(db[s * kRows + t]) <= r_eff2)) continue;
    const int j = c + (s < w ? s - w : s - w + 1);
    const float dx = sx[j] - qx;
    const float dy = sy[j] - qy;
    const float dz = sz[j] - qz;
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
  out[1 * n + i] = s0;
  out[2 * n + i] = s1x;
  out[3 * n + i] = s1y;
  out[4 * n + i] = s1z;
  out[5 * n + i] = sxx;
  out[6 * n + i] = syy;
  out[7 * n + i] = szz;
  out[8 * n + i] = sxy;
  out[9 * n + i] = sxz;
  out[10 * n + i] = syz;
}

}  // namespace

extern "C" int bst_stats_sweep(const float* px, const float* py,
                               const float* pz, const uint8_t* mask,
                               float* out, int n, int w, int r_k, int r_cap,
                               float r2, void* stream) {
  if (n <= 0 || w < 1) return cudaErrorInvalidValue;
  const int smem = (4 * (kRows + 2 * w) + 2 * w * kRows) * 4;
  cudaFuncSetAttribute(stats_sweep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stats_sweep_kernel<<<(n + kRows - 1) / kRows, kRows, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, mask, out, n, w, r_k, r_cap, r2);
  return static_cast<int>(cudaGetLastError());
}
