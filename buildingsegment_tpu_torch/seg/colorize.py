"""Plane colorization — deterministic per-plane random colors.

A jax-free copy of ``buildingsegment_tpu/seg/colorize.py`` (that module
is reachable only through ``buildingsegment_tpu.seg``, which imports
jax).  Re-implements ``seg_plane::set_plane_color``
(tmc3/my_function.cpp:260-275): every point starts black; each accepted
plane, in id order, draws three values ``55 + rand() % 200`` from the
unseeded MSVC CRT ``rand()`` (LCG ``x ← x·214013 + 2531011``, seed 1),
landing on green, blue, red in that order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MsvcRand", "msvc_rand_colors", "colorize_planes"]


class MsvcRand:
    """MSVC CRT rand(): LCG x ← x·214013 + 2531011 (mod 2³²), 15-bit out."""

    def __init__(self, seed: int = 1):
        self._state = seed & 0xFFFFFFFF

    def __call__(self) -> int:
        self._state = (self._state * 214013 + 2531011) & 0xFFFFFFFF
        return (self._state >> 16) & 0x7FFF


def msvc_rand_colors(
    num_planes: int, low: int = 55, rng_range: int = 200, seed: int = 1
) -> np.ndarray:
    """Color table uint16[num_planes, 3] in internal (g, b, r) order;
    row p is the color of plane id p+1."""
    rand = MsvcRand(seed)
    out = np.empty((num_planes, 3), np.uint16)
    for p in range(num_planes):
        out[p, 0] = low + rand() % rng_range  # green
        out[p, 1] = low + rand() % rng_range  # blue
        out[p, 2] = low + rand() % rng_range  # red
    return out


def colorize_planes(
    plane_idx: np.ndarray,
    num_planes: int,
    *,
    low: int = 55,
    rng_range: int = 200,
    seed: int = 1,
) -> np.ndarray:
    """Per-point colors uint16[N, 3] (g, b, r): black or the plane color."""
    table = np.zeros((num_planes + 1, 3), np.uint16)
    if num_planes:
        table[1:] = msvc_rand_colors(num_planes, low, rng_range, seed)
    ids = np.where(plane_idx > 0, plane_idx, 0)
    return table[ids]
