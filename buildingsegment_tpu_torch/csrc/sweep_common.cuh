// Shared pieces of the window sweeps (label_sweep.cu, compact_sweep.cu).
//
// The per-candidate hop/merge test of the window solver, written in the
// operation order of buildingsegment_tpu/ops/window_sweep.py
// _label_kernel (and of its plain PyTorch versions).  The library is
// built with -fmad=false, so every a*b + c below rounds the product and
// the sum separately, exactly as the plain versions do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
