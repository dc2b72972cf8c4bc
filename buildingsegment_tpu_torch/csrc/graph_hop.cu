// graph_hop: the graph solve's walk over the kNN edges, in one kernel with
// two uses — a sweep's hop (adopt and push along every edge) and its
// union hook (adjacent regions whose models accept each other).
//
// Replaces no Pallas kernel.  It stands in for the JAX package's XLA
// gathers and `.at[].min` scatters of `one_hop` and `merge_labels`
// (buildingsegment_tpu/seg/region_grow.py:528-546, :653-680), which the
// port's plain versions (ops/graph_hop.py graph_hop_reference,
// graph_union_reference) write as [N, K-1] and [N, K-1, 3] gathers and a
// scatter_reduce_ "amin" over every edge, with one dummy slot for the
// edges that do not push.
//
// hop: out = min(label, adopted, pushed), with
//   adopted[i] = min over valid edges i -> t of label[t] where the model
//     of label[t] accepts point i (the reverse edges: i adopts);
//   pushed[t] = min over valid edges i -> t of label[i] where the model
//     of label[i] accepts point t (the forward edges: i pushes).
// union: parent = identity, then for every valid edge i -> t with labels
//   la = label[i] != lb = label[t], both below inf, whose models accept
//   each other's centre and normal both ways, parent[max] = min(min).
// "accepts": d = |((px - cx)*nx + (py - cy)*ny) + (pz - cz)*nz| <= th and
// c = cmag((qx*nx + qy*ny) + qz*nz) >= cth, (n, c) the model, (p, q) the
// point's position and normal, each product and sum rounded alone (the
// library is built with -fmad=false), the thresholds as float32 values —
// the plain versions' expressions in their order, so a gate decides the
// same on both; a NaN fails both compares in both.  A min over a set does
// not depend on the order of the atomics, so every run gives the same
// bits, equal to the plain versions'.
//
// Layout: a point's lanes are a half-warp for K-1 <= 16 slots, a whole
// warp up to 32; lane s takes slot s (the id table holds the K-1 non-self
// slots, int32, row-major, beside one validity byte an edge).  Points are
// f32[n, 8] rows (position, pad, normal, pad) and the models f32[ng, 8]
// rows (unit normal, pad, centre, pad): two 16-byte loads a row.
//
// Atomics only where a label falls.  A lane tests its edge one way at
// most: the reverse test only where label[t] < label[i] (a larger label
// cannot lower min(label[i], ...)), the forward test only where
// label[i] < label[t] (out[t] <= label[t] always holds, so a push of a
// label at or above it cannot lower out[t]); equal labels test nothing.
// The reverse candidates of a point meet in a shuffle min and lane 0
// issues one atomicMin where it lies below label[i]; a push issues one
// where a read of out[t] still lies above the pushed label (out only
// falls, so a stale read is at or above the true value and skipping is
// exact).  The union reads parent[max] the same way before its hook.
// That removes the plain version's one-address contention on the dummy
// slot, and once regions settle most edges issue nothing.
//
// What bounds it on the H100: bytes.  A hop at the exact cell's mean
// 1.15M points reads the ids (64 MB), the validity bytes (16 MB), labels
// in and out (9 MB) and positions and normals (28 MB of the function's
// 24 B a point) once: ~120 MB, ~35 us at 3.35 TB/s; the live models'
// rows stay in L2.  The neighbours' labels and rows are gathers, mostly
// near the point in the scan's order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGraphThreads = 256;
constexpr int kGraphMaxSlots = 32;

struct GraphParams {
  float th;   // plane band |(p - c)·n| <= th
  float cth;  // normal agreement cmag(q·n) >= cth
  int inf;    // "no label": ng, the models' row count
  int sgn;    // 1: signed cos test
};

__device__ __forceinline__ float graph_cmag(float x, int sgn) {
  return sgn ? x : fabsf(x);
}

// Does the model (mn, mc) accept the point at p with normal q?
__device__ __forceinline__ bool graph_accepts(float4 mn, float4 mc, float4 p,
                                              float4 q, const GraphParams& g) {
  const float d = fabsf((p.x - mc.x) * mn.x + (p.y - mc.y) * mn.y +
                        (p.z - mc.z) * mn.z);
  const float c = graph_cmag(q.x * mn.x + q.y * mn.y + q.z * mn.z, g.sgn);
  return d <= g.th && c >= g.cth;
}

// One point's edges, lane s on slot s.  kUnion: the union hook into
// `dst` (parent); else the hop into `dst` (out, a copy of label).
template <int kLanes, bool kUnion>
__global__ void __launch_bounds__(kGraphThreads)
graph_walk_kernel(const int* __restrict__ label, const int* __restrict__ nb,
                  const uint8_t* __restrict__ valid,
                  const float4* __restrict__ pts,
                  const float4* __restrict__ models, int* dst, int n, int kk,
                  GraphParams g) {
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * (kGraphThreads / kLanes) + threadIdx.x / kLanes;
  const bool live = i < n;
  const int li = live ? label[i] : g.inf;
  int cand = g.inf;  // the lane's reverse candidate (hop)
  if (live && lane < kk) {
    const size_t e = static_cast<size_t>(i) * kk + lane;
    const int t = nb[e];
    if (valid[e] && static_cast<unsigned>(t) < static_cast<unsigned>(n)) {
      const int lt = label[t];
      if (kUnion) {
        if (li < g.inf && lt < g.inf && li != lt) {
          const float4 an = models[2 * li], ac = models[2 * li + 1];
          const float4 bn = models[2 * lt], bc = models[2 * lt + 1];
          if (graph_accepts(an, ac, bc, bn, g) &&
              graph_accepts(bn, bc, ac, an, g)) {
            const int hi = max(li, lt), lo = min(li, lt);
            if (__ldcg(dst + hi) > lo) atomicMin(dst + hi, lo);
          }
        }
      } else if (lt < li) {  // reverse: i may adopt lt
        if (graph_accepts(models[2 * lt], models[2 * lt + 1], pts[2 * i],
                          pts[2 * i + 1], g))
          cand = lt;
      } else if (li < lt) {  // forward: i may push li to t
        if (graph_accepts(models[2 * li], models[2 * li + 1], pts[2 * t],
                          pts[2 * t + 1], g) &&
            __ldcg(dst + t) > li)
          atomicMin(dst + t, li);
      }
    }
  }
  if constexpr (!kUnion) {
    // every lane of the warp reaches the shuffles
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, off, kLanes));
    if (live && lane == 0 && cand < li) atomicMin(dst + i, cand);
  }
}

__global__ void iota_kernel(int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = i;
}

template <bool kUnion>
cudaError_t launch_walk(const int* label, const int* nb, const uint8_t* valid,
                        const float* pts, const float* models, int* dst,
                        int n, int kk, const GraphParams& g,
                        cudaStream_t st) {
  const auto p4 = reinterpret_cast<const float4*>(pts);
  const auto m4 = reinterpret_cast<const float4*>(models);
  if (kk <= 16) {
    constexpr int kPoints = kGraphThreads / 16;
    graph_walk_kernel<16, kUnion>
        <<<(n + kPoints - 1) / kPoints, kGraphThreads, 0, st>>>(
            label, nb, valid, p4, m4, dst, n, kk, g);
  } else {
    constexpr int kPoints = kGraphThreads / 32;
    graph_walk_kernel<32, kUnion>
        <<<(n + kPoints - 1) / kPoints, kGraphThreads, 0, st>>>(
            label, nb, valid, p4, m4, dst, n, kk, g);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// label int32[n] (values in [0, ng]; ng is "no label"), nb int32[n, kk]
// row-major, valid uint8[n, kk], pts f32[n, 8], models f32[ng, 8] (16-byte
// aligned); out int32[n] gets the hop.  1 <= kk <= 32.
int bst_graph_hop(const int* label, const int* nb, const uint8_t* valid,
                  const float* pts, const float* models, int* out, int n,
                  int kk, int ng, float th, float cth, int sgn,
                  void* stream) {
  if (n < 0 || ng < 0 || kk < 1 || kk > kGraphMaxSlots)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out, label, sizeof(int) * n,
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  return launch_walk<false>(label, nb, valid, pts, models, out, n, kk,
                            GraphParams{th, cth, ng, sgn}, st);
}

// As bst_graph_hop, without the points; parent int32[ng] gets the
// identity with every hook applied (before any jump round).
int bst_graph_union(const int* label, const int* nb, const uint8_t* valid,
                    const float* models, int* parent, int n, int kk, int ng,
                    float th, float cth, int sgn, void* stream) {
  if (n < 0 || ng < 0 || kk < 1 || kk > kGraphMaxSlots)
    return cudaErrorInvalidValue;
  if (ng == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  iota_kernel<<<(ng + 255) / 256, 256, 0, st>>>(parent, ng);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return err;
  return launch_walk<true>(label, nb, valid, nullptr, models, parent, n, kk,
                           GraphParams{th, cth, ng, sgn}, st);
}

}  // extern "C"
