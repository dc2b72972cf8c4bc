// label_sweep: one window label-propagation sweep.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/window_sweep.py
// _label_kernel (wrapper label_sweep, pallas_call via _sweep_call).
//
// What bounds it on the H100: memory and launch latency.  A row reads
// its own 12 floats + label + mask once (about 60 B) and its 2w window
// candidates, which are its neighbours in memory and come from L1/L2;
// at the slice's 223k rows a sweep moves about 13 MB, a few microseconds
// of HBM time, so the launch and the tail dominate.
//
// Design: the TPU kernel DMA'd a padded [16, T+2w] slab per tile into
// VMEM.  Here one thread owns one row and runs the 2w offset loop over
// the SoA component arrays directly; neighbouring threads read
// neighbouring addresses, so every candidate load is coalesced and
// served by L1.  A candidate outside [0, n) counts as masked (what the
// slab's sentinel fill did).  Labels are int32 with `inf` = "none".
// Staging the block's [T+2w] rows in shared memory is left until a
// timing shows the L1 path matters.
#include "sweep_common.cuh"

namespace {

__global__ void label_sweep_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const float* __restrict__ mnx, const float* __restrict__ mny,
    const float* __restrict__ mnz, const float* __restrict__ mcx,
    const float* __restrict__ mcy, const float* __restrict__ mcz,
    const int* __restrict__ label, const uint8_t* __restrict__ mask,
    int* __restrict__ new_out, int* __restrict__ best_out, int n, int w,
    WindowParams p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  RowModel r{px[i],  py[i],  pz[i],  nx[i],  ny[i],  nz[i],
             mnx[i], mny[i], mnz[i], mcx[i], mcy[i], mcz[i]};
  int lab0 = label[i];
  bool has = lab0 < p.inf;
  int nw = lab0;
  int best = p.inf;
  if (mask[i]) {
    for (int slot = 0; slot < 2 * w; ++slot) {
      int j = i + (slot < w ? slot - w : slot - w + 1);
      if (j < 0 || j >= n || !mask[j]) continue;
      if (!window_near(r, px[j], py[j], pz[j], p.eg2)) continue;
      window_candidate(r, lab0, has, label[j], mnx[j], mny[j], mnz[j],
                       mcx[j], mcy[j], mcz[j], p, nw, best);
    }
  }
  new_out[i] = nw;
  best_out[i] = best;
}

}  // namespace

extern "C" {

const char* bst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bst_label_sweep(const float* px, const float* py, const float* pz,
                    const float* nx, const float* ny, const float* nz,
                    const float* mnx, const float* mny, const float* mnz,
                    const float* mcx, const float* mcy, const float* mcz,
                    const int* label, const uint8_t* mask, int* new_out,
                    int* best_out, int n, int w, float th, float cth,
                    float eg2, int inf, int sgn, void* stream) {
  WindowParams p{th, cth, eg2, inf, sgn};
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    label_sweep_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        px, py, pz, nx, ny, nz, mnx, mny, mnz, mcx, mcy, mcz, label, mask,
        new_out, best_out, n, w, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
