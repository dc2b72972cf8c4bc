"""The plain reference of the survey's three ortho images: a copy of the
arithmetic of ``buildingsegment_tpu_torch/raster/ortho.py`` (commit
e8749d5) on the frozen plain splat and histogram sums (tmc3/TMC3.cpp:
81-198).  ``tf32=True`` is the control: the same arithmetic with TF32
products (:mod:`benchmark.reference.precision`)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference.plain.core.pointset import PAD_COORD
from benchmark.reference.plain.ops.scatter import bilinear_splat
from benchmark.reference.plain.ops.segsum import plane_sums
from benchmark.reference.precision import tf32_products

#: file name → (raster index: 0 mean height, 1 log density, 2 blank;
#: the RGB channel it lands in), as the port names them (TMC3.cpp:98-119)
PNGS = {"平均高度.png": (0, 0), "像素数量.png": (1, 1),
        "像素数量+高度.png": (2, 1)}


def _ground_threshold(pos, mask, z_extent, bin_height):
    num_bins = z_extent // bin_height + 1
    z_bin = torch.where(mask, pos[:, 2] // bin_height,
                        num_bins).to(torch.int32)
    ones = torch.ones((pos.shape[0], 1), dtype=torch.float32,
                      device=pos.device)
    acc = plane_sums(z_bin, ones, num_bins, table_cap=max(num_bins, 1))
    hist = acc[:num_bins, 0].to(torch.int32)
    half = mask.to(torch.int32).sum() // 2
    above = torch.cumsum(hist, 0) > half
    i = torch.where(above.any(), torch.argmax(above.to(torch.uint8)),
                    num_bins)
    return (i * bin_height).to(torch.int32)


def _to_png(channel: np.ndarray, target: int) -> np.ndarray:
    ch = np.asarray(channel, np.float64)
    img = np.zeros(ch.shape + (3,), np.uint8)
    m = ch.max()
    if m != 0:
        img[:, :, target] = (255.0 * ch / m).astype(np.uint8)
    return img


def rasters_reference(shifted: np.ndarray, capacity: int, params: dict,
                      device, tf32: bool = False) -> dict:
    """{file name: uint8[H, W, 3]} of one scan from its shifted positions
    int32[n, 3], padded to ``capacity`` rows as the run pads them."""
    n = shifted.shape[0]
    pos = np.full((capacity, 3), PAD_COORD, np.int32)
    pos[:n] = shifted
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    extent = tuple(int(e) for e in shifted.max(axis=0)) if n else (0, 0, 0)
    bin_xy = params["raster_bin"]
    with torch.no_grad(), (tf32_products() if tf32
                           else contextlib.nullcontext()):
        p = torch.from_numpy(pos).to(device)
        m = torch.from_numpy(mask).to(device)
        th = _ground_threshold(p, m, extent[2], params["raster_bin_height"])
        density, height_sum = bilinear_splat(
            p, m, th, width=extent[0] // bin_xy + 2,
            height=extent[1] // bin_xy + 2, bin_size=bin_xy)
        nz = density != 0
        mean_h = torch.where(nz, height_sum / torch.where(nz, density, 1.0),
                             height_sum)
        logd = torch.log(density + 1.0)
        logd = torch.where(logd != 0,
                           logd + params["raster_density_offset"], logd)
        planes = [mean_h.cpu().numpy(), logd.cpu().numpy(),
                  np.zeros(tuple(density.shape), np.float32)]
    return {name: _to_png(planes[i], chan)
            for name, (i, chan) in PNGS.items()}
