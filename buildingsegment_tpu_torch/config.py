"""Pipeline configuration — the port's copy of ``buildingsegment_tpu/config.py``.

The fields and defaults are the JAX package's, so one configuration
means the same run in both packages.  Of the fields that select a TPU
kernel variant, the port reads ``stats_rank_mode`` and ``seg_seed_mode``:
"mxu" selects the block-form stats and fine seed sweeps
(``ops/stats_mxu.py``), which round differently from the exact ones;
every other value the JAX package accepts gives the exact sweep, whose
variants there are bit-identical.  ``stats_store_offsets`` and
``stats_sym`` select bit-identical variants and are kept, unread, for
the equality.  The JAX package's environment defaults of these fields
(``BST_RANK_MODE``, ``BST_SEED_MODE``, ``BST_STATS_SYM``) are not read:
the port takes its paths from the configuration only.  ``knn_k_pad`` is
read as the JAX package reads it: the exact-kNN paths search
``max(knn_k_pad, normal_max_nn)`` neighbours.

Every hard-coded constant of the reference binary becomes a field here,
with the reference's value as the default so the default-configured
pipeline matches reference behavior.  Citations point at the reference
source that defines each constant:

- position_scale = 1000        (tmc3/TMC3.cpp:207 — "to millimeters")
- knn_k = 15                   (tmc3/TMC3.cpp:215 — template arg K)
- normal_radius = 100          (tmc3/my_function.h:63 — Hybrid radius, 0.1 m)
- normal_max_nn = 50           (tmc3/my_function.h:63 — Hybrid max_nn)
- th_thickness = 300           (tmc3/my_function.h:117 — point-to-plane mm)
- th_point_count = 400         (tmc3/my_function.h:118 — min plane size, strict >)
- th_normal_cos = 0.88         (tmc3/my_function.cpp:230 — normal agreement)
- raster_bin = 100             (tmc3/TMC3.cpp:177 — 0.1 m ortho cell)
- raster_bin_height = 1000     (tmc3/TMC3.cpp:177 — 1 m ground histogram bin)
- raster_channels = 3          (tmc3/TMC3.cpp:178)
- contour_threshold = 10       (tmc3/my_function.cpp:20)
- contour_min_area = 500       (tmc3/my_function.cpp:42)
- contour_min_perimeter = 100  (tmc3/my_function.cpp:42)
- color_low/range 55/200       (tmc3/my_function.cpp:269 — 55 + rand() % 200)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Configuration for the end-to-end segmentation pipeline.

    Defaults reproduce the reference binary's hard-coded constants.
    """

    # --- I/O / quantization ---
    position_scale: float = 1000.0  # input units → integer mm
    output_scale: float = 1.0       # written positions = int mm × this
    output_binary: bool = True      # reference writes binary_little_endian

    # --- kNN graph ---
    knn_k: int = 15                 # includes self at slot 0
    # Padded k for TPU-friendly shapes (lane-sized multiples); slots
    # beyond knn_k are masked out.  The exact-kNN paths search
    # max(knn_k_pad, normal_max_nn) neighbours.
    knn_k_pad: int = 16
    # "auto": Morton-window search above knn_auto_threshold points,
    # exact brute force below; "brute" / "window" force a method.
    knn_method: str = "auto"
    # ± half-window in Morton order (the JAX package's production
    # default, chosen there on the TPU)
    knn_window: int = 48
    knn_auto_threshold: int = 65536
    # every shifted coordinate < 2^20 mm (1048 m): the Morton sort then
    # drops its residual word (one int64 sort key).  Host drivers set
    # this from the scan bbox at
    # read time; False is always safe.
    morton_small: bool = False

    # --- normal estimation ---
    normal_radius: float = 100.0    # hybrid neighborhood radius (mm)
    normal_max_nn: int = 50         # hybrid neighborhood max neighbors
    normal_orient_z: bool = True    # flip normals so n·(0,0,1) ≥ 0

    # --- region growing ---
    th_thickness: float = 300.0     # max |point-to-plane| distance (mm)
    th_point_count: int = 400       # plane accepted iff size > this
    th_normal_cos: float = 0.88     # min cos(normal angle) for membership
    # optional explicit curvature cap on seeds (None = reference
    # semantics: the all-neighbors rule is the only planarity gate)
    th_seed_curvature: Optional[float] = None
    max_sweeps: int = 64            # fixed-point propagation sweep budget
    max_planes: int = 4096          # fixed-capacity plane table
    # stop sweeping when fewer than tol×N labels change per sweep
    # (exact fixed point when tol×N < 1; default trades the last
    # straggler-polishing sweeps for throughput)
    seg_convergence_tol: float = 5e-5
    # multigrid coarsening factor for the windowized solver (Morton
    # groups of this size become super-points; 1 = single level)
    seg_group: int = 4
    # recursive coarsening depth / per-point refinement sweeps.
    # 2 levels + 2 refine sweeps: the JAX package's production default
    # (chosen there on the TPU for speed at equal agreement).  Density is
    # handled by the spacing_hint_mm edge-gate scaling (r4): sparse
    # scans keep coarse connectivity (tests/test_multigrid.py density
    # sweep pins 50/150/300 mm), dense scans keep tight gates.
    seg_levels: int = 2
    seg_refine_sweeps: int = 2      # per-point refinement sweeps
    # anchor-pure model estimation (region_grow.segment_planes
    # th_anchor_cos): members feed their region's mean model only when
    # their normal agrees with the region seed's normal by this cosine
    # (≤ th_normal_cos disables).  Guards the running mean against
    # ridge blend-strip drift: tools/anchor_sweep.py (production path)
    # shows 0.95 separates shallow-dihedral ridges that merge at every
    # lower value, and is equal-or-better on every other scene.
    # ``None`` (the default) lets each solver use its default (both
    # 0.95); every pipeline entry (sharded or not) must thread this
    # identically — a round-3 regression had the sharded path at 0.0
    # and the unsharded at 0.95, silently breaking 8-shard ≡ 1-shard.
    seg_anchor_cos: Optional[float] = None

    # --- colorize ---
    color_low: int = 55             # 55 + rand() % 200 per channel
    color_range: int = 200
    color_rng: str = "msvc"         # "msvc" reproduces unseeded MSVC rand()

    # --- ortho raster ---
    raster_bin: int = 100           # ortho cell edge (mm)
    raster_bin_height: int = 1000   # ground z-histogram bin (mm)
    raster_channels: int = 3
    raster_density_offset: float = 20.0  # added to nonzero log-density

    # --- contour extraction ---
    contour_threshold: float = 10.0
    contour_min_area: float = 500.0
    contour_min_perimeter: float = 100.0
    contour_close_iters: int = 2
    contour_kernel_size: int = 5    # ellipse structuring element

    # --- perf variant knobs of the JAX package (its bench.py autotunes
    # them on the TPU; the port reads seg_compact, stats_rank_mode and
    # seg_seed_mode) ---
    # compact-space coarse solver (ops/compact_sweep.py); None defers
    # to the BST_COMPACT env default read at import
    seg_compact: Optional[bool] = None
    # stats sweep of the multigrid path: None | "bitonic" | "bisect" =
    # the exact sweep (JAX's two rankings are bit-identical); "mxu" =
    # the block-form sweep (ops/stats_mxu.py, near-exact).  Read by the
    # port; JAX's None defers to BST_RANK_MODE, the port's to the exact
    # sweep.
    stats_rank_mode: Optional[str] = None
    # TPU stats kernel phase 3: re-read candidates at stored aligned
    # offsets instead of strided rows (bit-identical; not read)
    stats_store_offsets: bool = True
    # TPU stats kernel phase 1: symmetry-halved pair sweep
    # (bit-identical; each unordered pair computed once; not read).
    # JAX's None defers to BST_STATS_SYM.
    stats_sym: Optional[bool] = None
    # fine seed sweep of the multigrid path: None | "pair" | "sym" =
    # the exact sweep (bit-identical in JAX); "mxu" = the block-form
    # sweep (ops/stats_mxu.py, near-exact).  Read by the port; JAX's
    # None defers to BST_SEED_MODE, the port's to the exact sweep.
    seg_seed_mode: Optional[str] = None
    # multigrid seed gate: None/"fine" = the fine-level window_seeds
    # sweep (the reference's depth-0 rule re-expressed,
    # tmc3/my_function.cpp:238); "coarse" = derive the gate from the
    # group-coherence statistics (skips the fine sweep; a different
    # seed criterion, seg/coarse.py)
    seg_seed_source: Optional[str] = None

    # Point-spacing hint (mm): when None, segment_cloud and
    # segment_files measure it on the device in stage 1 (the occupied
    # 512 mm cells of the Morton order; the hint
    # core.quantize.estimate_spacing_mm gives, bucketed to powers of
    # two), and the multigrid edge gates then scale with the MEASURED
    # density instead of growing sqrt(group) per level
    # unconditionally — dense scans keep tight gates at every level
    # (no cross-building bridging), sparse scans get exactly the reach
    # connectivity needs (seg/coarse.py).  A value set here is used as
    # given; run_device_pipeline and dist/ read None as no hint: the
    # conservative unconditional scaling applies.
    spacing_hint_mm: Optional[float] = None

    # quantized-duplicate removal before segmentation (the reference's
    # removeDuplicatePointInQuantizedPoint, tmc3/PCCPointSet.h:457-472):
    # None = off (the reference's main() never calls it); N ≥ 0 =
    # remove points identical after dropping N low bits, first
    # occurrence in index order survives.  CLI: --dedup-bits N.
    dedup_bits: Optional[int] = None

    # --- capacity / sharding ---
    pad_to_multiple: int = 1024     # point capacity rounded up to this
    num_shards: Optional[int] = None  # None → use all local devices

    def padded_count(self, n: int) -> int:
        """Round ``n`` up to the configured capacity multiple (min 1 tile)."""
        m = self.pad_to_multiple
        return max(m, ((n + m - 1) // m) * m)


DEFAULT_CONFIG = PipelineConfig()
