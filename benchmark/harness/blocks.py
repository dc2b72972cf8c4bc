"""The street blocks a block configuration's pool holds: nx × ny gabled
houses (the frozen ``scenes.make_building_cloud``, without its ground)
on one shared ground, with uniform scatter in the block's box, as the
port's ``utils/synthetic.make_block_cloud`` lays a block out, but with
each house's footprint fixed by its place in the block and the seed
moving only the sampling jitter, the noise, the scatter's positions and
each dimension by at most ``scene["size_jitter"]`` (a share).

A block scene (the configuration's ``scene``) gives ``grids``, the
blocks' house grids [nx, ny] in the pool's order, of which the pool takes
the first ``pool``; ``pitch_mm`` [x, y], the grid's pitch; ``smallest``
and ``largest``, the house dimensions (``scenes.DIMS``) a block's houses
run over evenly in row order; ``spacing_mm``, ``noise_mm`` and
``clutter_frac``, the scatter as a share of the surface points.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from benchmark.harness.scenes import DIMS, make_building_cloud, pool_sizes


def block_jobs(scene: dict, seed: int) -> List[dict]:
    """The pool's blocks as keyword arguments of :func:`make_block`, in
    the pool's order: their houses' dimensions (jittered) and seeds."""
    grids = scene["grids"][:scene["pool"]]
    if len(grids) < scene["pool"]:
        raise ValueError(f"pool {scene['pool']} but {len(grids)} grids")
    rng = np.random.default_rng([seed % 2 ** 64, 11])
    jobs = []
    for nx, ny in grids:
        houses = []
        for size in pool_sizes(dict(scene, pool=nx * ny)):
            jit = rng.uniform(-1.0, 1.0, len(DIMS)) * scene["size_jitter"]
            houses.append({d: size[d] * (1.0 + j) for d, j in zip(DIMS, jit)})
        jobs.append(dict(nx=nx, ny=ny, houses=houses,
                         seed=int(rng.integers(1 << 31))))
    return jobs


def make_block(*, nx: int, ny: int, houses: List[dict], seed: int,
               pitch_mm, spacing_mm: float, noise_mm: float,
               clutter_frac: float) -> Tuple[np.ndarray, np.ndarray]:
    """One block: house k of ``houses`` at grid cell (k // ny, k % ny) of
    ``pitch_mm``, one ground over the whole grid, then uniform scatter of
    ``clutter_frac`` of the surface points in the block's box.

    Returns (positions int32[N, 3] in mm, shifted to positive and
    shuffled, truth int32[N]: a plane id unique in the block, 0 for the
    scatter)."""
    rng = np.random.default_rng(seed)
    px, py = float(pitch_mm[0]), float(pitch_mm[1])
    parts, truths = [], []
    next_id = 1
    for k, dims in enumerate(houses):
        i, j = divmod(k, ny)
        pts, t = make_building_cloud(
            seed=int(rng.integers(1 << 30)), spacing_mm=spacing_mm,
            noise_mm=noise_mm, ground=False, **dims)
        parts.append(pts.astype(np.int64)
                     + np.array([round(i * px), round(j * py), 0]))
        truths.append(np.where(t > 0, t + next_id - 1, 0).astype(np.int32))
        next_id = int(truths[-1].max()) + 1
    ext_x, ext_y = nx * px, ny * py
    ngx = max(int(ext_x / spacing_mm), 2)
    ngy = max(int(ext_y / spacing_mm), 2)
    mx, my = np.meshgrid((np.arange(ngx) + 0.5) / ngx * ext_x,
                         (np.arange(ngy) + 0.5) / ngy * ext_y, indexing="ij")
    ground = np.stack([mx.ravel(), my.ravel(),
                       rng.normal(0.0, noise_mm, mx.size)], axis=-1)
    parts.append(np.round(ground).astype(np.int64))
    truths.append(np.full(len(ground), next_id, np.int32))
    positions = np.concatenate(parts)
    truth = np.concatenate(truths)
    n_junk = int(len(positions) * clutter_frac)
    if n_junk:
        lo, hi = positions.min(0), positions.max(0)
        junk = rng.uniform(lo, hi, size=(n_junk, 3)).astype(np.int64)
        positions = np.concatenate([positions, junk])
        truth = np.concatenate([truth, np.zeros(n_junk, np.int32)])
    positions = positions - positions.min(axis=0)
    order = rng.permutation(len(positions))
    return positions[order].astype(np.int32), truth[order]


def make_block_pool(scene: dict, seed: int) -> List[np.ndarray]:
    """The pool's scans, int32[n, 3] mm each, in the pool's order."""
    common = {k: scene[k] for k in ("pitch_mm", "spacing_mm", "noise_mm",
                                    "clutter_frac")}
    jobs = [dict(job, **common) for job in block_jobs(scene, seed)]
    # the blocks are independent: made side by side (numpy leaves the
    # interpreter lock in its bulk work)
    with ThreadPoolExecutor(max_workers=min(len(jobs), 4)) as pool:
        return [pts for pts, _truth in pool.map(
            lambda kw: make_block(**kw), jobs)]
