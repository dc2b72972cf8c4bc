"""Synthetic building scans with analytically known plane decomposition.

The port's copy of ``buildingsegment_tpu/utils/synthetic.py``: the
same scenes, bit for bit, from the same seed and arguments.

Test/benchmark fixture generator (SURVEY.md §4 "golden end-to-end"):
axis-aligned walls + gabled roof planes + ground, sampled on jittered
grids, in integer millimeters.  Each point carries its ground-truth
plane id so segmentation quality is measurable without the reference
binary.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "make_building_cloud",
    "make_cylinder_cloud",
    "make_terrain_cloud",
    "make_block_cloud",
]


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


def make_cylinder_cloud(
    seed: int = 0,
    *,
    radius_mm: float = 3000.0,
    height_mm: float = 6000.0,
    spacing_mm: float = 80.0,
    noise_mm: float = 5.0,
    ground: bool = True,
    ground_extent_mm: float = 10_000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """A vertical cylinder tank on a ground plane — a CURVED surface.

    No planar decomposition of the shell is "correct"; both the
    reference algorithm and the rebuild carve it into vertical strips
    bounded by the thickness/angle gates.  Truth ids: 0 for the shell
    (no true plane), 1 for the ground.
    """
    rng = np.random.default_rng(seed)
    n_c = max(int(2 * np.pi * radius_mm / spacing_mm), 8)
    n_h = max(int(height_mm / spacing_mm), 2)
    theta = (np.arange(n_c) + rng.uniform(0.25, 0.75, n_c)) / n_c * 2 * np.pi
    z = (np.arange(n_h) + rng.uniform(0.25, 0.75, n_h)) / n_h * height_mm
    tt, zz = np.meshgrid(theta, z, indexing="ij")
    r = radius_mm + rng.normal(0, noise_mm, tt.size).reshape(tt.shape)
    shell = np.stack(
        [r * np.cos(tt), r * np.sin(tt), zz], axis=-1
    ).reshape(-1, 3)
    parts = [shell]
    truth = [np.zeros(len(shell), np.int32)]
    if ground:
        e = ground_extent_mm
        n_g = max(int(e / spacing_mm), 2)
        g = (np.arange(n_g) + 0.5) / n_g * e - e / 2
        gx, gy = np.meshgrid(g, g, indexing="ij")
        gpts = np.stack(
            [gx.ravel(), gy.ravel(),
             rng.normal(0, noise_mm, gx.size)], axis=-1
        )
        keep = np.hypot(gpts[:, 0], gpts[:, 1]) > radius_mm
        parts.append(gpts[keep])
        truth.append(np.ones(int(keep.sum()), np.int32))
    positions = np.concatenate(parts)
    truth = np.concatenate(truth)
    positions = positions - positions.min(axis=0)
    order = rng.permutation(len(positions))
    return np.round(positions[order]).astype(np.int32), truth[order]


def make_terrain_cloud(
    seed: int = 0,
    *,
    extent_mm: float = 20_000.0,
    spacing_mm: float = 100.0,
    slope: float = 0.15,
    roll_amp_mm: float = 0.0,
    roll_period_mm: float = 8_000.0,
    noise_mm: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sloped (optionally gently rolling) terrain.

    With roll_amp_mm=0 the truth is a single tilted plane (id 1);
    nonzero roll makes it curved (truth 0 — no exact plane).
    """
    rng = np.random.default_rng(seed)
    n = max(int(extent_mm / spacing_mm), 2)
    g = (np.arange(n) + rng.uniform(0.25, 0.75, n)) / n * extent_mm
    gx, gy = np.meshgrid(g, g, indexing="ij")
    z = slope * gx + roll_amp_mm * np.sin(
        2 * np.pi * gx / roll_period_mm
    ) * np.sin(2 * np.pi * gy / roll_period_mm)
    z = z + rng.normal(0, noise_mm, z.shape)
    positions = np.stack([gx.ravel(), gy.ravel(), z.ravel()], axis=-1)
    tid = 1 if roll_amp_mm == 0.0 else 0
    truth = np.full(len(positions), tid, np.int32)
    positions = positions - positions.min(axis=0)
    order = rng.permutation(len(positions))
    return np.round(positions[order]).astype(np.int32), truth[order]


def make_block_cloud(
    seed: int = 0,
    *,
    nx: int = 3,
    ny: int = 2,
    gap_mm: float = 4_000.0,
    spacing_mm: float = 120.0,
    noise_mm: float = 8.0,
    clutter_frac: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """A dense city block: nx × ny gabled houses on one shared ground,
    varying footprints/heights, optional uniform clutter (fraction of
    total points).  Truth ids are globally unique per plane."""
    rng = np.random.default_rng(seed)
    parts, truths = [], []
    next_id = 1
    for i in range(nx):
        for j in range(ny):
            w = rng.uniform(5_000, 9_000)
            d = rng.uniform(4_000, 7_000)
            h = rng.uniform(3_000, 6_000)
            pts, t = make_building_cloud(
                seed=int(rng.integers(1 << 30)),
                spacing_mm=spacing_mm, width_mm=w, depth_mm=d,
                wall_h_mm=h, ridge_h_mm=h * rng.uniform(1.2, 1.5),
                noise_mm=noise_mm, ground=False,
            )
            pts = pts + np.array(
                [i * (9_000 + gap_mm), j * (7_000 + gap_mm), 0], np.int32
            )
            t = np.where(t > 0, t + next_id - 1, 0)
            next_id = int(t.max()) + 1
            parts.append(pts)
            truths.append(t)
    # one shared ground
    ext_x = nx * (9_000 + gap_mm)
    ext_y = ny * (7_000 + gap_mm)
    ngx = max(int(ext_x / spacing_mm), 2)
    ngy = max(int(ext_y / spacing_mm), 2)
    gx = (np.arange(ngx) + 0.5) / ngx * ext_x
    gy = (np.arange(ngy) + 0.5) / ngy * ext_y
    mx, my = np.meshgrid(gx, gy, indexing="ij")
    gpts = np.stack(
        [mx.ravel(), my.ravel(), rng.normal(0, noise_mm, mx.size)], axis=-1
    )
    parts.append(np.round(gpts).astype(np.int32))
    truths.append(np.full(len(gpts), next_id, np.int32))
    positions = np.concatenate(parts).astype(np.int64)
    truth = np.concatenate(truths)
    if clutter_frac > 0:
        n_j = int(len(positions) * clutter_frac)
        lo, hi = positions.min(0), positions.max(0)
        junk = rng.uniform(lo, hi, size=(n_j, 3)).astype(np.int64)
        positions = np.concatenate([positions, junk])
        truth = np.concatenate([truth, np.zeros(n_j, np.int32)])
    positions = positions - positions.min(axis=0)
    order = rng.permutation(len(positions))
    return positions[order].astype(np.int32), truth[order]
