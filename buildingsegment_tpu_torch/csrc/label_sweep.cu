// label_sweep: one window label-propagation sweep.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/window_sweep.py
// _label_kernel (wrapper label_sweep, pallas_call via _sweep_call).
//
// What bounds it on the H100: latency at the path's sizes, operations at
// the largest.  The deepest level of the default path solves 13,952 rows
// (55 blocks of 256 one-row threads for 132 SMs) and a row walks its
// 2w = 32 slots (w = 16, seg/coarse.py) each as a chain of dependent
// loads behind branches: mask, position, then label and six model
// floats.  So the first call's time was the length of one row's chain,
// not the card's bandwidth (about 60 B a row, 0.8 MB a call) or its
// operations.  At the single-level path's 223,232 rows the ~40 f32
// operations of each (row, candidate) pair set the bound.
//
// Design: a block owns 64 consecutive rows and stages rows
// [b0 - w, b0 + 64 + w) once in shared memory, with coalesced loads, as
// three float4s a row: (x, y, z, label bits), the model normal and the
// model center.  A row outside [0, n) or masked is staged with x = NaN,
// so its edge gate (a d² <= eg2 compare) fails without a branch, as the
// plain version's mask and padding do.  Four lanes share a row: lane l
// takes slots l, l + 4, ... of the 2w (eight each at w = 16, unrolled in
// the instance with w fixed), and two xor shuffles join the lanes' hop
// minimum `nw` and merge-hook minimum `best`.  An integer min is exact
// in any order and split, and each candidate's test is the exact f32
// operations of the plain version (sweep_common.cuh, -fmad=false), so
// the output equals it bit for bit.  A masked row runs no slot and
// writes its own label and `inf`.  At 13,952 rows the tile gives 218
// blocks, a candidate's data is one shared read, and a row's chain is a
// quarter as long.  A window too wide for the tile (w > 2048: the three
// staged float4s a row then pass the shared-memory budget) takes the
// one-thread-a-row kernel, which reads its candidates from L1.  Labels
// are int32 with `inf` = "none".
#include "sweep_common.cuh"

namespace {

constexpr int kLabelRows = 64;        // rows a tile block owns
constexpr int kLabelLanes = 4;        // lanes that share one row
constexpr int kLabelThreads = kLabelRows * kLabelLanes;
constexpr int kLabelTileMaxW = 2048;  // widest window the tile takes

// The tile kernel: see the design note above.  Shared memory: (x, y, z,
// label bits), (mn, 0) and (mc, 0) for the staged rows [64 + 2w] each.
// kW > 0 fixes the window half-width at compile time (the path's w = 16);
// kW = 0 takes w at run time.
template <int kW>
__global__ void __launch_bounds__(kLabelThreads) label_tile_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const float* __restrict__ mnx, const float* __restrict__ mny,
    const float* __restrict__ mnz, const float* __restrict__ mcx,
    const float* __restrict__ mcy, const float* __restrict__ mcz,
    const int* __restrict__ label, const uint8_t* __restrict__ mask,
    int* __restrict__ new_out, int* __restrict__ best_out, int n, int w_run,
    WindowParams p) {
  const int w = kW > 0 ? kW : w_run;
  extern __shared__ float4 sm[];
  const int span = kLabelRows + 2 * w;
  float4* sp = sm;
  float4* smn = sp + span;
  float4* smc = smn + span;
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kLabelRows;
  const float qnan = __int_as_float(0x7fc00000);  // fails every compare
  for (int s = t; s < span; s += kLabelThreads) {
    const int j = b0 - w + s;
    float4 a = make_float4(qnan, 0.f, 0.f, __int_as_float(p.inf));
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 c = m;
    if (j >= 0 && j < n) {
      const bool ok = mask[j] != 0;
      a = make_float4(ok ? px[j] : qnan, py[j], pz[j],
                      __int_as_float(label[j]));
      m = make_float4(mnx[j], mny[j], mnz[j], 0.f);
      c = make_float4(mcx[j], mcy[j], mcz[j], 0.f);
    }
    sp[s] = a;
    smn[s] = m;
    smc[s] = c;
  }
  __syncthreads();

  const int r = t / kLabelLanes;
  const int lane = t % kLabelLanes;
  const int i = b0 + r;
  const float4 me = sp[r + w];
  const int lab0 = __float_as_int(me.w);
  int nw = lab0;
  int best = p.inf;
  // a masked row (x = NaN) or a row past n runs no slot; all four lanes
  // of a row take the same branch
  if (i < n && me.x == me.x) {
    const float4 m = smn[r + w], c = smc[r + w];
    const RowModel rm{me.x, me.y, me.z, nx[i], ny[i], nz[i],
                      m.x,  m.y,  m.z,  c.x,   c.y,   c.z};
    const bool has = lab0 < p.inf;
#pragma unroll(kW > 0 ? (2 * kW) / kLabelLanes : 1)
    for (int slot = lane; slot < 2 * w; slot += kLabelLanes) {
      const int s = r + slot + (slot >= w);
      const float4 b = sp[s];
      if (!window_near(rm, b.x, b.y, b.z, p.eg2)) continue;
      const float4 bm = smn[s], bc = smc[s];
      window_candidate(rm, lab0, has, __float_as_int(b.w), bm.x, bm.y, bm.z,
                       bc.x, bc.y, bc.z, p, nw, best);
    }
  }
#pragma unroll
  for (int o = kLabelLanes / 2; o > 0; o >>= 1) {
    nw = min(nw, __shfl_xor_sync(0xffffffffu, nw, o));
    best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
  }
  if (i < n && lane == 0) {
    new_out[i] = nw;
    best_out[i] = best;
  }
}

// The per-row kernel, for windows the tile cannot hold: one thread a row
// walks its 2w slots from L1.  A candidate outside [0, n) counts as
// masked (what the TPU slab's sentinel fill did).
__global__ void label_row_kernel(
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

template <int kW>
cudaError_t launch_tile(const float* px, const float* py, const float* pz,
                        const float* nx, const float* ny, const float* nz,
                        const float* mnx, const float* mny, const float* mnz,
                        const float* mcx, const float* mcy, const float* mcz,
                        const int* label, const uint8_t* mask, int* new_out,
                        int* best_out, int n, int w, WindowParams p,
                        cudaStream_t st) {
  const int smem =
      3 * (kLabelRows + 2 * w) * static_cast<int>(sizeof(float4));
  static std::atomic<int> limit{0};  // this instance's shared-memory limit
  const cudaError_t err = raise_smem_limit(label_tile_kernel<kW>, smem, limit);
  if (err != cudaSuccess) return err;
  label_tile_kernel<kW><<<(n + kLabelRows - 1) / kLabelRows, kLabelThreads,
                          smem, st>>>(px, py, pz, nx, ny, nz, mnx, mny, mnz,
                                      mcx, mcy, mcz, label, mask, new_out,
                                      best_out, n, w, p);
  return cudaSuccess;
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
  if (n < 0 || w < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  WindowParams p{th, cth, eg2, inf, sgn};
  const auto st = static_cast<cudaStream_t>(stream);
  if (w <= kLabelTileMaxW) {
    const cudaError_t err =
        w == 16 ? launch_tile<16>(px, py, pz, nx, ny, nz, mnx, mny, mnz, mcx,
                                  mcy, mcz, label, mask, new_out, best_out, n,
                                  w, p, st)
                : launch_tile<0>(px, py, pz, nx, ny, nz, mnx, mny, mnz, mcx,
                                 mcy, mcz, label, mask, new_out, best_out, n,
                                 w, p, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const int threads = 256;
    label_row_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(
        px, py, pz, nx, ny, nz, mnx, mny, mnz, mcx, mcy, mcz, label, mask,
        new_out, best_out, n, w, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
