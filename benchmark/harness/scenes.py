"""The scans the benchmark runs: a frozen copy of the port's
``make_building_cloud`` (``buildingsegment_tpu_torch/utils/synthetic.py``
at commit e8749d5, the same scenes bit for bit from the same seed and
arguments), and the pool of scans a configuration names."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np


def _sample_plane(
    rng: np.random.Generator,
    origin: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    nu: int,
    nv: int,
    noise_mm: float,
) -> np.ndarray:
    """Jittered-grid samples of the parallelogram origin + [0,1]u + [0,1]v."""
    gu = (np.arange(nu) + rng.uniform(0.25, 0.75, nu)) / nu
    gv = (np.arange(nv) + rng.uniform(0.25, 0.75, nv)) / nv
    uu, vv = np.meshgrid(gu, gv, indexing="ij")
    pts = (
        origin[None, :]
        + uu.reshape(-1, 1) * u[None, :]
        + vv.reshape(-1, 1) * v[None, :]
    )
    normal = np.cross(u, v)
    normal = normal / np.linalg.norm(normal)
    pts = pts + rng.normal(0.0, noise_mm, (pts.shape[0], 1)) * normal[None, :]
    return pts


def make_building_cloud(
    seed: int = 0,
    *,
    spacing_mm: float = 150.0,
    width_mm: float = 12_000.0,
    depth_mm: float = 9_000.0,
    wall_h_mm: float = 6_000.0,
    ridge_h_mm: float = 9_000.0,
    noise_mm: float = 20.0,
    ground: bool = True,
    walls: bool = True,
    clutter: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build a gabled house: 4 walls, 2 roof pitches, 2 gable triangles
    (sampled as quads and clipped), optional ground plane and clutter.

    Returns:
        (positions int32[N, 3] in mm, shifted to positive,
         truth int32[N] ground-truth plane id: 1..P, 0 = clutter).
    """
    rng = np.random.default_rng(seed)
    w, d, h, rh = width_mm, depth_mm, wall_h_mm, ridge_h_mm
    planes = []

    def quad(origin, u, v):
        nu = max(int(np.linalg.norm(u) / spacing_mm), 2)
        nv = max(int(np.linalg.norm(v) / spacing_mm), 2)
        return _sample_plane(
            rng, np.asarray(origin, float), np.asarray(u, float),
            np.asarray(v, float), nu, nv, noise_mm,
        )

    # walls (y=0, y=d, x=0, x=w) — vertical planes are where the
    # reference's ±Z normal orientation is unstable; exclude them to
    # get a scene where signed-normal semantics are well-posed
    if walls:
        planes.append(quad([0, 0, 0], [w, 0, 0], [0, 0, h]))
        planes.append(quad([0, d, 0], [w, 0, 0], [0, 0, h]))
        planes.append(quad([0, 0, 0], [0, d, 0], [0, 0, h]))
        planes.append(quad([w, 0, 0], [0, d, 0], [0, 0, h]))
    # roof pitches meeting at the ridge x = w/2
    planes.append(quad([0, 0, h], [w / 2, 0, rh - h], [0, d, 0]))
    planes.append(quad([w, 0, h], [-w / 2, 0, rh - h], [0, d, 0]))
    if ground:
        margin = 0.3 * max(w, d)
        planes.append(
            quad([-margin, -margin, 0], [w + 2 * margin, 0, 0], [0, d + 2 * margin, 0])
        )

    positions = np.concatenate(planes)
    truth = np.concatenate(
        [np.full(len(p), i + 1, np.int32) for i, p in enumerate(planes)]
    )

    if clutter:
        lo = positions.min(axis=0)
        hi = positions.max(axis=0)
        junk = rng.uniform(lo, hi, size=(clutter, 3))
        positions = np.concatenate([positions, junk])
        truth = np.concatenate([truth, np.zeros(clutter, np.int32)])

    positions = positions - positions.min(axis=0)
    order = rng.permutation(len(positions))
    return np.round(positions[order]).astype(np.int32), truth[order]


#: the dimensions a pool's footprints run over, evenly from smallest to
#: largest
DIMS = ("width_mm", "depth_mm", "wall_h_mm", "ridge_h_mm")


def pool_sizes(scene: dict) -> List[dict]:
    """The pool's footprints in their fixed order: ``scene["pool"]`` sizes
    spread evenly from ``smallest`` to ``largest``."""
    k = scene["pool"]
    lo, hi = scene["smallest"], scene["largest"]
    return [{d: lo[d] + (hi[d] - lo[d]) * i / max(k - 1, 1) for d in DIMS}
            for i in range(k)]


def make_pool(scene: dict, seed: int) -> List[np.ndarray]:
    """The pool's scans, int32[n, 3] mm each, in the pool's order.  The
    seed moves only the sampling jitter, the noise and each dimension by
    at most ``scene["size_jitter"]`` (a share), so every seed gives the
    same mix of sizes."""
    rng = np.random.default_rng(seed % 2 ** 64)
    jobs = []
    for size in pool_sizes(scene):
        jit = rng.uniform(-1.0, 1.0, len(DIMS)) * scene["size_jitter"]
        dims = {d: size[d] * (1.0 + j) for d, j in zip(DIMS, jit)}
        jobs.append(dict(seed=int(rng.integers(1 << 31)),
                         spacing_mm=scene["spacing_mm"],
                         noise_mm=scene["noise_mm"], **dims))
    # the scans are independent: made side by side (numpy leaves the
    # interpreter lock in its bulk work)
    with ThreadPoolExecutor(max_workers=min(len(jobs), 4)) as pool:
        return [pts for pts, _truth in pool.map(
            lambda kw: make_building_cloud(**kw), jobs)]
