// seed_sweep: the depth-0 seed rule over a +-w Morton window.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/window_sweep.py
// _seed_kernel_sym (wrapper seed_sweep_pair(sym=True), called from
// seg/region_grow.py window_seeds); its twin _seed_kernel_pair computes
// the same function bit for bit.
//
// Row i is a seed iff it is valid and no valid window candidate j inside
// its k-th-NN ball (|p_j - p_i|^2 <= dk_i) fails the plane test on row
// i's normal: |(p_j - p_i)·n_i| <= th and |n_j·n_i| >= cos.
//
// What bounds it on the H100: memory and launch latency.  A row reads its
// own 32 B (position, normal, ball, mask) and its 2w candidates, which
// are its neighbours in memory and come from L1/L2; at the slice's 223k
// rows the sweep moves about 7 MB, a few microseconds of HBM time.
//
// Design: the TPU kernel halved its misaligned slab reads by testing each
// unordered pair once and updating both ends.  On Hopper the candidate
// loads are coalesced L1 hits, so one thread owns one row, runs the 2w
// offsets in the plain order and stops at the first failing candidate.
// The tests are the exact f32 operations of the plain version (built
// with -fmad=false), so the output equals it bit for bit.
#include "sweep_common.cuh"

namespace {

__global__ void seed_sweep_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const uint8_t* __restrict__ mask, const float* __restrict__ dk,
    uint8_t* __restrict__ seed, int n, int w, float th, float cth, int sgn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool ok = mask[i] != 0;
  if (ok) {
    const float qx = px[i], qy = py[i], qz = pz[i];
    const float qnx = nx[i], qny = ny[i], qnz = nz[i];
    const float ball = dk[i];
    for (int slot = 0; slot < 2 * w; ++slot) {
      const int j = i + (slot < w ? slot - w : slot - w + 1);
      if (j < 0 || j >= n || !mask[j]) continue;
      const float dx = px[j] - qx;
      const float dy = py[j] - qy;
      const float dz = pz[j] - qz;
      if (!(dx * dx + dy * dy + dz * dz <= ball)) continue;
      const float pd = fabsf(dx * qnx + dy * qny + dz * qnz);
      const float pc = cmag(nx[j] * qnx + ny[j] * qny + nz[j] * qnz, sgn);
      if (!(pd <= th && pc >= cth)) {
        ok = false;
        break;
      }
    }
  }
  seed[i] = ok;
}

}  // namespace

extern "C" int bst_seed_sweep(const float* px, const float* py,
                              const float* pz, const float* nx,
                              const float* ny, const float* nz,
                              const uint8_t* mask, const float* dk,
                              uint8_t* seed, int n, int w, float th,
                              float cth, int sgn, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int threads = 256;
  seed_sweep_kernel<<<(n + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, nx, ny, nz, mask, dk, seed, n, w, th, cth, sgn);
  return static_cast<int>(cudaGetLastError());
}
