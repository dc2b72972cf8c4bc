// Shared pieces of the window sweeps (label_sweep.cu, compact_sweep.cu,
// seed_sweep.cu, refine_sweep.cu).
//
// The per-candidate hop/merge test of the window solver, written in the
// operation order of buildingsegment_tpu/ops/window_sweep.py
// _label_kernel (and of its plain PyTorch versions).  The library is
// built with -fmad=false, so every a*b + c below rounds the product and
// the sum separately, exactly as the plain versions do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// Dynamic shared memory one block may take on the H100 (227 KB).
constexpr int kSmemBudget = 232448;

// Raises `kernel`'s dynamic shared-memory limit to `bytes` where a launch
// needs more than the 48 KB default and more than `limit`, the largest
// size already set for it: once per process and size, not per launch.
template <typename Kernel>
inline cudaError_t raise_smem_limit(Kernel kernel, int bytes,
                                    std::atomic<int>& limit) {
  if (bytes <= 48 * 1024 || bytes <= limit.load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int cur = limit.load();
  while (cur < bytes && !limit.compare_exchange_weak(cur, bytes)) {
  }
  return cudaSuccess;
}

struct WindowParams {
  float th;     // plane band |(p - c)·n| <= th
  float cth;    // normal agreement |n·m| >= cth
  float eg2;    // edge gate |p_i - p_j|^2 <= eg2
  int inf;      // "no label"
  int sgn;      // 1: signed cos tests (reference orientation semantics)
};

__device__ __forceinline__ float cmag(float x, int sgn) {
  return sgn ? x : fabsf(x);
}

struct RowModel {
  float px, py, pz;     // position
  float nx, ny, nz;     // unit normal
  float mnx, mny, mnz;  // model normal of the row's own label
  float mcx, mcy, mcz;  // model center of the row's own label
};

// One candidate j of row i (already known to be inside [0, n), valid
// and within the edge gate).  Updates the hop minimum `nw` and the
// merge-hook minimum `best`.
__device__ __forceinline__ void window_candidate(
    const RowModel& r, int lab0, bool has, int cl,
    float cmnx, float cmny, float cmnz,
    float cmcx, float cmcy, float cmcz,
    const WindowParams& p, int& nw, int& best) {
  float d = fabsf((r.px - cmcx) * cmnx + (r.py - cmcy) * cmny +
                  (r.pz - cmcz) * cmnz);
  float c = cmag(r.nx * cmnx + r.ny * cmny + r.nz * cmnz, p.sgn);
  if (cl < p.inf && d <= p.th && c >= p.cth) nw = min(nw, cl);
  if (has && cl < lab0) {
    float dcx = cmcx - r.mcx;
    float dcy = cmcy - r.mcy;
    float dcz = cmcz - r.mcz;
    bool mutual =
        fabsf(dcx * r.mnx + dcy * r.mny + dcz * r.mnz) <= p.th &&
        fabsf(dcx * cmnx + dcy * cmny + dcz * cmnz) <= p.th &&
        cmag(r.mnx * cmnx + r.mny * cmny + r.mnz * cmnz, p.sgn) >= p.cth;
    if (mutual) best = min(best, cl);
  }
}

// Edge gate between row i and candidate j (both inside [0, n)).
__device__ __forceinline__ bool window_near(
    const RowModel& r, float qx, float qy, float qz, float eg2) {
  float dx = r.px - qx;
  float dy = r.py - qy;
  float dz = r.pz - qz;
  return dx * dx + dy * dy + dz * dz <= eg2;
}

// One row of a staged window tile (label_sweep.cu's tile, compact_sweep.cu's
// hop): rows [b0 - w, b0 + rows + w) of the block sit in shared memory as
// three float4s a row -- (x, y, z, label bits) with x = NaN for a masked
// row or one outside [0, n), so its edge gate fails without a branch; the
// model normal; the model center -- and block row r (staged at r + w, row
// i of the problem) walks its 2w slots with kLanes lanes, lane l taking
// slots l, l + kLanes, ...  Xor shuffles join the lanes' hop minimum `nw`
// and merge-hook minimum `best` (integer mins: exact in any order and
// split).  A masked row or one past n runs no slot: nw = its label, best =
// inf.  kW > 0 fixes w at compile time.  Every lane of the warp calls it.
template <int kW, int kLanes>
__device__ __forceinline__ void window_tile_row(
    const float4* sp, const float4* smn, const float4* smc, int r, int lane,
    int w, int i, int n, const float* __restrict__ nx,
    const float* __restrict__ ny, const float* __restrict__ nz,
    const WindowParams& p, int& nw, int& best) {
  const float4 me = sp[r + w];
  const int lab0 = __float_as_int(me.w);
  nw = lab0;
  best = p.inf;
  // all lanes of a row take the same branch
  if (i < n && me.x == me.x) {
    const float4 m = smn[r + w], c = smc[r + w];
    const RowModel rm{me.x, me.y, me.z, nx[i], ny[i], nz[i],
                      m.x,  m.y,  m.z,  c.x,   c.y,   c.z};
    const bool has = lab0 < p.inf;
#pragma unroll(kW > 0 ? (2 * kW) / kLanes : 1)
    for (int slot = lane; slot < 2 * w; slot += kLanes) {
      const int s = r + slot + (slot >= w);
      const float4 b = sp[s];
      if (!window_near(rm, b.x, b.y, b.z, p.eg2)) continue;
      const float4 bm = smn[s], bc = smc[s];
      window_candidate(rm, lab0, has, __float_as_int(b.w), bm.x, bm.y, bm.z,
                       bc.x, bc.y, bc.z, p, nw, best);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    nw = min(nw, __shfl_xor_sync(0xffffffffu, nw, o));
    best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
  }
}
