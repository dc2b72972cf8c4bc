// refine_sweep: one full-resolution refinement sweep of the multigrid
// solver against the [P] plane table.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/window_sweep.py
// _refine_table_kernel_pair (wrapper refine_table_sweep_pair, called from
// seg/coarse.py step 3).
//
// Per row i with plane id pid_i (0 = none) and plane p's model (unit
// normal n_p, offset b_p = n_p·c_p):
//   accept(i, p):  |p_i·n_p - b_p| <= th and |n_i·n_p| >= cos;
//   eff(i)      :  pid_i if row i is valid, has a plane and (with
//                  `clean`) its own plane still accepts it, else 0;
//   out(i)      :  eff(i) if > 0, else (with `adopt`) the smallest eff(j)
//                  over valid window candidates j within the edge gate
//                  whose plane accepts row i, else 0.
//
// What bounds it on the H100: memory and launch latency.  A row reads its
// 32 B (position, normal, id, mask) and the ids of its 2w neighbours from
// L1/L2, and writes 4 B: about 8 MB at the slice's 223k rows.
//
// Design: the TPU kernel built every row's model with a one-hot matmul
// over the live 128-id chunks of the table (one nonzero per column, so
// a gather).  Here the live rows of the table (ids up to ceil128(n_live),
// at most max_planes = 4096 rows of (n, b), 64 KB) sit in shared memory
// and a row's model is a direct read.  One thread owns one row; a
// candidate's `clean` test is recomputed where it is read (two dot
// products), which costs less than a second pass over the rows.  Ids are
// int32 (the TPU kernel carried them as floats).  The tests are the exact
// f32 operations of the plain version (-fmad=false): the output equals
// it bit for bit.
#include <climits>

#include "sweep_common.cuh"

namespace {

struct RefineParams {
  float th, cth, eg2;
  int sgn, clean, adopt;
};

__device__ __forceinline__ float4 plane_of(const float4* tab, int pid,
                                           int ntab) {
  return (pid > 0 && pid <= ntab) ? tab[pid - 1]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
}

// does plane m accept row i: |p·n - b| <= th and |n_i·n| >= cos
__device__ __forceinline__ bool accepts(float4 m, float x, float y, float z,
                                        float ux, float uy, float uz,
                                        const RefineParams& p) {
  const float d = fabsf(x * m.x + y * m.y + z * m.z - m.w);
  const float c = cmag(ux * m.x + uy * m.y + uz * m.z, p.sgn);
  return d <= p.th && c >= p.cth;
}

__global__ void refine_sweep_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const uint8_t* __restrict__ mask, const int* __restrict__ pid,
    const float4* __restrict__ table, int ntab, int* __restrict__ out,
    int n, int w, RefineParams p) {
  extern __shared__ float4 tab[];  // [ntab] rows (n_x, n_y, n_z, b)
  for (int k = threadIdx.x; k < ntab; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = px[i], y = py[i], z = pz[i];
  const float ux = nx[i], uy = ny[i], uz = nz[i];
  const bool valid = mask[i] != 0;
  int keep = (valid && pid[i] > 0) ? pid[i] : 0;
  if (keep > 0 && p.clean &&
      !accepts(plane_of(tab, keep, ntab), x, y, z, ux, uy, uz, p))
    keep = 0;
  if (keep > 0 || !p.adopt || !valid) {
    out[i] = keep;
    return;
  }
  int best = INT_MAX;
  for (int slot = 0; slot < 2 * w; ++slot) {
    const int j = i + (slot < w ? slot - w : slot - w + 1);
    if (j < 0 || j >= n || !mask[j]) continue;
    const int cp = pid[j];
    if (cp <= 0 || cp >= best) continue;
    const float cx = px[j], cy = py[j], cz = pz[j];
    const float dx = x - cx;
    const float dy = y - cy;
    const float dz = z - cz;
    if (!(dx * dx + dy * dy + dz * dz <= p.eg2)) continue;
    const float4 m = plane_of(tab, cp, ntab);
    if (p.clean && !accepts(m, cx, cy, cz, nx[j], ny[j], nz[j], p)) continue;
    if (accepts(m, x, y, z, ux, uy, uz, p)) best = cp;
  }
  out[i] = best < INT_MAX ? best : 0;
}

}  // namespace

extern "C" int bst_refine_sweep(const float* px, const float* py,
                                const float* pz, const float* nx,
                                const float* ny, const float* nz,
                                const uint8_t* mask, const int* pid,
                                const float* table, int ntab, int* out, int n,
                                int w, float th, float cth, float eg2, int sgn,
                                int clean, int adopt, void* stream) {
  if (n <= 0 || ntab < 0) return cudaErrorInvalidValue;
  RefineParams p{th, cth, eg2, sgn, clean, adopt};
  const int smem = ntab * static_cast<int>(sizeof(float4));
  cudaFuncSetAttribute(refine_sweep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int threads = 256;
  refine_sweep_kernel<<<(n + threads - 1) / threads, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, nx, ny, nz, mask, pid,
      reinterpret_cast<const float4*>(table), ntab, out, n, w, p);
  return static_cast<int>(cudaGetLastError());
}
