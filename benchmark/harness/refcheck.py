"""The reference's side of the comparison: for each sampled scan, read the
input file with the benchmark's own reader, run the plain reference of
the configuration's kNN path on the card, and compare the port's outputs
with it.  The control puts the reference computed with TF32 products in
the port's place."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark.harness.check import ScanOut, compare_scan, worst
from benchmark.harness.paths import load_path
from benchmark.reference.io import read_input_mm, read_png, read_ply_vertices
from benchmark.reference.raster import PNGS, rasters_reference
from benchmark.reference.segment import RefScan


def padded_count(n: int, multiple: int) -> int:
    """Rows a run pads ``n`` points to (the configuration's
    ``pad_to_multiple``, at least one tile)."""
    return max(multiple, -(-n // multiple) * multiple)


def bucket_capacity(n: int, multiple: int) -> int:
    """The multi-scan entry's capacity: an eighth-octave bucket of the
    padded count, re-aligned to the multiple (a copy of the arithmetic of
    ``pipeline._bucket_capacity`` at commit e8749d5)."""
    cap = padded_count(n, multiple)
    octave = 1 << max(cap.bit_length() - 1, 3)
    for num in range(8, 17):
        bucket = octave // 8 * num
        if bucket >= cap:
            break
    return max(padded_count(bucket, multiple), multiple)


def read_written_ply(path: str) -> dict:
    """Positions (int, as the port writes them at scale 1) and colours
    (g, b, r) of a labeled PLY."""
    v = read_ply_vertices(path)
    pos = np.stack([v[a] for a in "xyz"], axis=1)
    ipos = np.rint(pos).astype(np.int64)
    ipos[np.any(ipos != pos, axis=1)] = -1  # a non-integer row cannot match
    cols = np.stack([v.get(c, np.zeros(len(pos), np.uint8))
                     for c in ("green", "blue", "red")], axis=1)
    return {"positions": ipos, "colors": cols.astype(np.uint16)}


def read_rasters(scan_dir: str) -> Dict[str, np.ndarray]:
    out = {}
    for name in PNGS:
        try:
            out[name] = read_png(f"{scan_dir}/{name}")
        except FileNotFoundError:
            pass
    return out


def as_control(ref: RefScan, stage1: bool, rasters: Optional[dict]) -> ScanOut:
    """The control's outputs in the port's place."""
    return ScanOut(
        labels=ref.labels, num_planes=ref.num_planes,
        plane_normals=ref.plane_normals, plane_centers=ref.plane_centers,
        plane_counts=ref.plane_counts,
        stage1=ref.stage1 if stage1 else None,
        ply={"positions": ref.shifted, "colors": ref.colors},
        rasters=rasters)


def file_numbers(cell, got: Dict[int, ScanOut], inputs: Dict[int, str],
                 capacity: Callable[[int], int], device,
                 rasters: bool = False,
                 control: bool = False) -> Dict[str, float]:
    """The worst case of each number over the sampled scans of a cell
    whose scans come from files: ``got[j]`` is what the timed path
    produced for pool scan j, ``inputs[j]`` its input PLY.  With
    ``control`` the port's outputs are ignored and the control stands in
    for them (``got`` names only the scans)."""
    params = cell.config["pipeline"]
    path = load_path(cell)
    per = []
    for j in sorted(got):
        if got[j] is None:  # an answer that never came
            per.append({"label_mismatch": 1.0})
            continue
        mm = read_input_mm(inputs[j])
        cap = capacity(mm.shape[0])
        ref = path.reference(mm, params, capacity=cap, device=device)
        ref_r = (rasters_reference(ref.shifted, cap, params, device)
                 if rasters else None)
        if control:
            ctl = path.reference(mm, params, capacity=cap, device=device,
                                 tf32=True)
            ctl_r = (rasters_reference(ctl.shifted, cap, params, device,
                                       tf32=True) if rasters else None)
            out = as_control(ctl, got[j].stage1 is not None, ctl_r)
        else:
            out = got[j]
        per.append(compare_scan(out, ref, path, rasters=ref_r))
        del ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return worst(per)
