"""Ortho rasterization: ground threshold, height/density images, PNGs.

Port of ``buildingsegment_tpu/raster/ortho.py``, the reference's
disabled-but-compiled raster path (``buildingSeg::{groundTH,
compute_gird_picture, save_image}``, tmc3/TMC3.cpp:81-198; BASELINE
config 5):

  * ground threshold: z-histogram in 1 m bins, on :func:`plane_sums`
    (kernel #8 on the card); the returned height is the bin floor where
    the cumulative count first exceeds half the points (≈ quantized
    median z, TMC3.cpp:181-198);
  * ortho images: bilinear splat of every point with z ≥ threshold into
    0.1 m cells — density in channel 1, mean height in channel 0
    (height_sum/density), then density ← log(density+1) (+20 where
    nonzero) (TMC3.cpp:127-172); channel 2 stays zero (its computation
    is commented out in the reference, TMC3.cpp:167-170);
  * PNG dump: per-channel max normalization to 0..255 (truncated), three
    RGB PNGs whose (Chinese) filenames the reference hard-codes:
    平均高度.png (mean height → R), 像素数量.png (log density → G),
    像素数量+高度.png (channel 2 → G; blank) (TMC3.cpp:81-121).

The JAX module rasters on padded shape buckets behind an ``lru_cache``
of jitted programs, only to spare the TPU a recompile per scan extent;
PyTorch runs eagerly, so the port rasters at the exact extent (the
pixels are the same: padded cells receive no points).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from buildingsegment_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from buildingsegment_tpu_torch.io.png import write_png
from buildingsegment_tpu_torch.ops.scatter import bilinear_splat
from buildingsegment_tpu_torch.ops.segsum import plane_sums

__all__ = [
    "ground_threshold",
    "compute_ortho_images",
    "normalize_to_png",
    "dispatch_ortho",
    "finish_ortho",
    "render_ortho_views",
    "MEAN_HEIGHT_PNG",
    "DENSITY_PNG",
    "DENSITY_HEIGHT_PNG",
]

# the reference's hard-coded output names (TMC3.cpp:98,108,119)
MEAN_HEIGHT_PNG = "平均高度.png"
DENSITY_PNG = "像素数量.png"
DENSITY_HEIGHT_PNG = "像素数量+高度.png"


def ground_threshold(
    positions: torch.Tensor,
    mask: torch.Tensor,
    z_extent: int,
    *,
    bin_height: int = 1000,
    z_true=None,
) -> torch.Tensor:
    """Quantized-median ground height (TMC3.cpp:181-198).

    Args:
        positions: int32[N, 3] shifted coords (z ≥ 0).
        mask: bool[N].
        z_extent: upper bound for z (bbox_max.z − bbox_min.z).
        z_true: the true z extent when ``z_extent`` is padded: the
            fall-off-the-end quirk then uses the true bin count.

    Returns:
        int32 0-d tensor on the positions' device: ``i × bin_height``
        where i is the first histogram bin at which the cumulative count
        exceeds half the points, or the bin count if none does.
    """
    num_bins = z_extent // bin_height + 1
    z_bin = torch.where(mask, positions[:, 2] // bin_height,
                        num_bins).to(torch.int32)
    ones = torch.ones((positions.shape[0], 1), dtype=torch.float32,
                      device=positions.device)
    # the histogram has ~a dozen live bins: a segment sum into a
    # 128-row table (masked rows land on bin num_bins, sliced off)
    acc = plane_sums(z_bin, ones, num_bins, table_cap=max(num_bins, 1))
    hist = acc[:num_bins, 0].to(torch.int32)
    half = mask.to(torch.int32).sum() // 2
    above = torch.cumsum(hist, 0) > half
    # the reference loop breaks at the first bin with cumulative > half;
    # if none exceeds (empty cloud) it falls off the end (i = size)
    i = torch.where(above.any(), torch.argmax(above.to(torch.uint8)),
                    num_bins)
    if z_true is not None:
        i = torch.clamp_max(i, int(z_true) // bin_height + 1)
    return (i * bin_height).to(torch.int32)


def compute_ortho_images(
    positions: torch.Tensor,
    mask: torch.Tensor,
    extent: Tuple[int, int, int],
    config: PipelineConfig = DEFAULT_CONFIG,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean-height / log-density / (zero) rasters.

    Args:
        positions: int32[N, 3] shifted coords.
        extent: (x, y, z) bbox extents of the cloud.

    Returns:
        (mean_height f32[H, W], log_density f32[H, W], zeros f32[H, W]),
        W = extent_x // bin + 2, H likewise (TMC3.cpp:75-77).
    """
    width = extent[0] // config.raster_bin + 2
    height = extent[1] // config.raster_bin + 2
    th = ground_threshold(positions, mask, extent[2],
                          bin_height=config.raster_bin_height)
    density, height_sum = bilinear_splat(
        positions, mask, th, width=width, height=height,
        bin_size=config.raster_bin,
    )
    nz = density != 0
    # mean height where density nonzero (TMC3.cpp:152-157)
    mean_height = torch.where(
        nz, height_sum / torch.where(nz, density, 1.0), height_sum)
    # log density, +offset where nonzero (TMC3.cpp:159-164)
    logd = torch.log(density + 1.0)
    logd = torch.where(logd != 0, logd + config.raster_density_offset, logd)
    return mean_height, logd, torch.zeros_like(density)


def normalize_to_png(channel: np.ndarray, target_channel: int) -> np.ndarray:
    """Max-normalize one raster into a uint8 RGB image (TMC3.cpp:85-119).

    The value lands in ``target_channel`` of an otherwise-black RGB
    image; an all-zero raster stays black (max==0 guard).
    """
    ch = np.asarray(channel, np.float64)
    h, w = ch.shape
    img = np.zeros((h, w, 3), np.uint8)
    m = ch.max()
    if m != 0:
        img[:, :, target_channel] = (255.0 * ch / m).astype(np.uint8)
    return img


def dispatch_ortho(
    positions_host: np.ndarray,
    device_shifted: torch.Tensor,
    device_mask: torch.Tensor,
    config: PipelineConfig = DEFAULT_CONFIG,
):
    """Queue the ortho raster on the device; :func:`finish_ortho` fetches it.

    Split from :func:`render_ortho_views` so the multi-scan writer can
    queue the raster before it blocks on its label fetch.  The rasters
    come from ``device_shifted``/``device_mask`` (the run's padded
    positions, already on its device) on their device; the extent is the
    host positions' bbox.  Returns f32[2, H, W] on that device: mean
    height, log density.
    """
    extent = (tuple(int(e) for e in positions_host.max(axis=0))
              if positions_host.shape[0] else (0, 0, 0))
    mean_h, logd, _ch2 = compute_ortho_images(device_shifted, device_mask,
                                              extent, config)
    return torch.stack([mean_h, logd])


def finish_ortho(rasters: torch.Tensor, out_dir: str) -> dict:
    """Fetch the rasters of :func:`dispatch_ortho`, encode and write the
    three PNGs into ``out_dir``; returns {filename: path}."""
    os.makedirs(out_dir, exist_ok=True)
    host = rasters.cpu().numpy()
    ch2 = np.zeros_like(host[0])
    paths = {}
    for name, raster, chan in (
        (MEAN_HEIGHT_PNG, host[0], 0),    # mean height → R (TMC3.cpp:93-98)
        (DENSITY_PNG, host[1], 1),        # log density → G (TMC3.cpp:103-108)
        (DENSITY_HEIGHT_PNG, ch2, 1),     # blank ch2 → G (TMC3.cpp:112-119)
    ):
        path = os.path.join(out_dir, name)
        write_png(path, normalize_to_png(raster, chan))
        paths[name] = path
    return paths


def render_ortho_views(pipeline_output, out_dir: str,
                       config: PipelineConfig = DEFAULT_CONFIG) -> dict:
    """Render and write the three reference PNGs; returns their paths.

    ``pipeline_output`` is a :class:`~buildingsegment_tpu_torch.pipeline
    .PipelineOutput` of ``segment_cloud``/``segment_file``: the raster
    reads the run's positions where the run left them (``device_shifted``,
    ``device_mask``), on that device.
    """
    rasters = dispatch_ortho(
        pipeline_output.cloud.positions,
        pipeline_output.device_shifted,
        pipeline_output.device_mask,
        config,
    )
    return finish_ortho(rasters, out_dir)
