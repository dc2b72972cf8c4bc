// knn_exact: the exact scan of the brute-force kNN (kernel #14).
//
// Replaces the TPU kernel buildingsegment_tpu/ops/pallas_knn.py _kernel
// (wrapper knn_pallas -> _dispatch, pallas_call at :777); its opt-in
// variant _kernel_resident computes the same function.
//
// For each query row q it keeps the kk = k-1 nearest candidates c with
// |c - q| > w_excl in sorted rank (the rank window is the seeds'
// territory), merged with q's window-kNN seed list, ordered by
// (d^2, index); d^2 = dx*dx + dy*dy + dz*dz in f32 diff form.  Rows at
// the -3e7 sentinel are invalid as queries and as candidates.
//
// What bounds it on the H100: operations.  Each visited (query,
// candidate) pair costs a d^2 and a compare, ~9 f32 operations, and the
// box pruning leaves a few candidate tiles per query tile; the bytes
// (positions, seeds, visit lists, outputs) are a few tens of MB.
//
// Design: one block per query tile of qt <= 128 queries, one thread per
// query.  The block walks its candidate tiles in the precomputed order
// of increasing box distance, at most counts[tile] of them, the first
// always; it stops at the first tile whose box bound exceeds tau, the
// largest current k-th distance over the block's valid queries (the
// list is sorted and tau only shrinks, so every later tile would be
// skipped too).  tau is a block reduction after each visited tile, so
// the visit decision is uniform.  A visited tile of ct <= 1024
// candidates is staged in shared memory (12 KB).  Each query's list
// lives in shared memory, slot-major [kk][qt] (49 x 128 x 8 B = 50 KB at
// k = 50; too large for registers), with the worst entry tracked in
// registers: a candidate enters only when its (d^2, index) is below the
// worst, replaces it and the list is rescanned for the new worst.  So
// the kept set is the kk smallest of seeds U visited candidates whatever
// the visit order, the same set the plain version keeps by brute force,
// and the box bound (a lower bound on every pair distance it covers,
// computed with the same rounding) guarantees no skipped tile holds a
// member.  Each row is written sorted by (d^2, index).  Built with
// -fmad=false, so d^2 rounds as in the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQt = 128;
constexpr int kMaxCt = 1024;
constexpr float kValidGt = -1e7f;

__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__global__ void knn_exact_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ seed_d,
    const int* __restrict__ seed_i, const int* __restrict__ visit,
    const float* __restrict__ visit_d2, const int* __restrict__ counts,
    float* __restrict__ out_d, int* __restrict__ out_i, int kk, int ct,
    int num_c, int w_excl) {
  extern __shared__ float smem[];
  const int qt = blockDim.x;
  float* cx = smem;
  float* cy = cx + ct;
  float* cz = cy + ct;
  float* bd = cz + ct;                              // [kk][qt]
  int* bi = reinterpret_cast<int*>(bd + kk * qt);  // [kk][qt]
  __shared__ float red[kMaxQt];
  __shared__ float tau;

  const int t = threadIdx.x;
  const int qtile = blockIdx.x;
  const int q = qtile * qt + t;
  const float qx = px[q], qy = py[q], qz = pz[q];
  const bool qvalid = qx > kValidGt;

  // the seed list, and its worst entry by (d^2, index)
  float wd = 0.f;
  int wi = 0, ws = 0;
  for (int s = 0; s < kk; ++s) {
    const float d = seed_d[(size_t)q * kk + s];
    const int i = seed_i[(size_t)q * kk + s];
    bd[s * qt + t] = d;
    bi[s * qt + t] = i;
    if (s == 0 || key_less(wd, wi, d, i)) {
      wd = d;
      wi = i;
      ws = s;
    }
  }
  red[t] = qvalid ? wd : 0.f;
  __syncthreads();
  if (t == 0) {
    float m = 0.f;
    for (int s = 0; s < qt; ++s) m = fmaxf(m, red[s]);
    tau = m;
  }
  __syncthreads();

  const int count = counts[qtile];
  for (int v = 0; v < count; ++v) {
    const size_t row = (size_t)qtile * num_c + v;
    if (v > 0 && !(visit_d2[row] <= tau)) break;
    const int base = visit[row] * ct;
    for (int j = t; j < ct; j += qt) {
      cx[j] = px[base + j];
      cy[j] = py[base + j];
      cz[j] = pz[base + j];
    }
    __syncthreads();
    if (qvalid) {
      for (int j = 0; j < ct; ++j) {
        const int c = base + j;
        const float x = cx[j];
        if (abs(c - q) <= w_excl || !(x > kValidGt)) continue;
        const float dx = qx - x;
        const float dy = qy - cy[j];
        const float dz = qz - cz[j];
        const float d = dx * dx + dy * dy + dz * dz;
        if (!key_less(d, c, wd, wi)) continue;
        bd[ws * qt + t] = d;
        bi[ws * qt + t] = c;
        wd = bd[t];
        wi = bi[t];
        ws = 0;
        for (int s = 1; s < kk; ++s) {
          const float ds = bd[s * qt + t];
          const int is = bi[s * qt + t];
          if (key_less(wd, wi, ds, is)) {
            wd = ds;
            wi = is;
            ws = s;
          }
        }
      }
    }
    red[t] = qvalid ? wd : 0.f;
    __syncthreads();  // also: every thread is done with the staged tile
    if (t == 0) {
      float m = 0.f;
      for (int s = 0; s < qt; ++s) m = fmaxf(m, red[s]);
      tau = m;
    }
    __syncthreads();
  }

  // write the row ascending by (d^2, index): selection sort in place
  for (int r = 0; r < kk; ++r) {
    int m = r;
    for (int s = r + 1; s < kk; ++s) {
      if (key_less(bd[s * qt + t], bi[s * qt + t], bd[m * qt + t],
                   bi[m * qt + t]))
        m = s;
    }
    const float dm = bd[m * qt + t];
    const int im = bi[m * qt + t];
    bd[m * qt + t] = bd[r * qt + t];
    bi[m * qt + t] = bi[r * qt + t];
    out_d[(size_t)q * kk + r] = dm;
    out_i[(size_t)q * kk + r] = im;
  }
}

}  // namespace

extern "C" int bst_knn_exact(const float* px, const float* py,
                             const float* pz, const float* seed_d,
                             const int* seed_i, const int* visit,
                             const float* visit_d2, const int* counts,
                             float* out_d, int* out_i, int n, int kk, int qt,
                             int ct, int w_excl, void* stream) {
  if (n <= 0 || kk <= 0 || qt <= 0 || qt > kMaxQt || ct <= 0 ||
      ct > kMaxCt || n % qt || n % ct)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * ct * sizeof(float) +
                      (size_t)kk * qt * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_exact_kernel<<<n / qt, qt, smem, static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, seed_d, seed_i, visit, visit_d2, counts, out_d, out_i, kk,
      ct, n / ct, w_excl);
  return static_cast<int>(cudaGetLastError());
}
