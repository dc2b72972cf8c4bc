"""Building-contour extraction from the ortho density raster.

The port's copy of ``buildingsegment_tpu/raster/contours.py`` (numpy,
with ``scipy.ndimage`` for the component labeling where it is installed
and a numpy union-find otherwise).  Re-implements the reference's
OpenCV stage (``extracted_contour``, tmc3/my_function.cpp:8-145)
without OpenCV:

  1. read the density PNG, take the green channel (the reference
     extracts channel 1, my_function.cpp:17-19);
  2. binary threshold at 10 (my_function.cpp:20);
  3. morphological close, 5×5 ellipse structuring element, 2 iterations
     (my_function.cpp:24-26) — shift-union dilation / shift-intersection
     erosion on the host (the raster is small; this is a cold path);
  4. external contours by Moore border tracing over 8-connected
     components (the RETR_EXTERNAL / CHAIN_APPROX_SIMPLE equivalent:
     collinear runs compressed to endpoints, my_function.cpp:31-33);
  5. filter: shoelace area > 500 and closed perimeter > 100
     (my_function.cpp:42);
  6. draw the filtered contours (cyan, width 2) onto the source image
     and also write a vertically flipped copy (my_function.cpp:56-58,
     139-144);
  7. extrude ALL contours (not only filtered — the reference loops over
     ``contours`` at my_function.cpp:79) to OBJ prisms via
     :mod:`buildingsegment_tpu_torch.io.obj`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from buildingsegment_tpu_torch.io.obj import write_prism_obj
from buildingsegment_tpu_torch.io.png import read_png, write_png

__all__ = [
    "ellipse_kernel_5x5",
    "morphology_close",
    "trace_external_contours",
    "contour_area",
    "contour_perimeter",
    "extract_contours",
    "extracted_contour",
]


def ellipse_kernel_5x5() -> np.ndarray:
    """OpenCV's MORPH_ELLIPSE 5×5 structuring element."""
    return np.array(
        [
            [0, 0, 1, 0, 0],
            [1, 1, 1, 1, 1],
            [1, 1, 1, 1, 1],
            [1, 1, 1, 1, 1],
            [0, 0, 1, 0, 0],
        ],
        dtype=bool,
    )


def _dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    padded = np.zeros((img.shape[0] + kh - 1, img.shape[1] + kw - 1), bool)
    padded[ay : ay + img.shape[0], ax : ax + img.shape[1]] = img
    out = np.zeros_like(img, dtype=bool)
    for dy in range(kh):
        for dx in range(kw):
            if kernel[dy, dx]:
                out |= padded[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return out


def _erode(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    padded = np.ones((img.shape[0] + kh - 1, img.shape[1] + kw - 1), bool)
    padded[ay : ay + img.shape[0], ax : ax + img.shape[1]] = img
    out = np.ones_like(img, dtype=bool)
    for dy in range(kh):
        for dx in range(kw):
            if kernel[dy, dx]:
                out &= padded[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return out


def morphology_close(
    img: np.ndarray, kernel: np.ndarray = None, iterations: int = 2
) -> np.ndarray:
    """Binary close: ``iterations`` dilations then ``iterations`` erosions
    (OpenCV ``morphologyEx(MORPH_CLOSE, k, iterations=n)`` semantics)."""
    k = ellipse_kernel_5x5() if kernel is None else kernel
    out = img.astype(bool)
    for _ in range(iterations):
        out = _dilate(out, k)
    for _ in range(iterations):
        out = _erode(out, k)
    return out


# Moore neighborhood in clockwise order starting East (dx, dy)
_MOORE = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)]


def _label_components(
    binary: np.ndarray, force_numpy: bool = False
) -> Tuple[np.ndarray, int]:
    """8-connected component labeling.

    Uses scipy.ndimage when available (C speed); otherwise a
    run-based two-pass union-find in numpy — rows decompose into runs
    of foreground, runs union with 8-overlapping runs of the previous
    row, so the python-level work is O(#runs), not O(pixels)."""
    if not force_numpy:
        try:
            from scipy import ndimage

            return ndimage.label(binary, structure=np.ones((3, 3), int))
        except ImportError:
            pass

    h, w = binary.shape
    labeled = np.zeros((h, w), np.int32)
    # run extraction for all rows at once
    padded = np.zeros((h, w + 2), bool)
    padded[:, 1:-1] = binary
    d = np.diff(padded.astype(np.int8), axis=1)
    starts_y, starts_x = np.nonzero(d == 1)  # run starts (inclusive)
    ends_y, ends_x = np.nonzero(d == -1)  # run ends (exclusive)
    n_runs = len(starts_x)
    parent = np.arange(n_runs + 1, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    # rows are sorted ascending by construction of nonzero
    row_start = np.searchsorted(starts_y, np.arange(h + 1))
    for y in range(1, h):
        a0, a1 = row_start[y], row_start[y + 1]
        b0, b1 = row_start[y - 1], row_start[y - 1 + 1]
        if a0 == a1 or b0 == b1:
            continue
        # 8-connectivity: run [s, e) touches prev-row run [s', e') iff
        # s <= e' and s' <= e (with ±1 diagonal slack folded in)
        for i in range(a0, a1):
            s, e = starts_x[i] - 1, ends_x[i] + 1
            j0 = np.searchsorted(ends_x[b0:b1], s, side="right") + b0
            for j in range(j0, b1):
                if starts_x[j] >= e:
                    break
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)

    roots = np.array([find(i) for i in range(n_runs)], np.int64)
    uniq, comp = np.unique(roots, return_inverse=True)
    comp = comp.astype(np.int32) + 1
    for i in range(n_runs):
        labeled[starts_y[i], starts_x[i] : ends_x[i]] = comp[i]
    return labeled, len(uniq)


def trace_external_contours(binary: np.ndarray) -> List[np.ndarray]:
    """External contours of 8-connected components, as (x, y) arrays.

    Moore border tracing with Jacob's stopping criterion; one outer
    contour per component (RETR_EXTERNAL).  Collinear runs are
    compressed to their endpoints (CHAIN_APPROX_SIMPLE equivalent).

    Work is O(pixels) for labeling + O(total perimeter) for tracing —
    no per-component full-raster scans, so a 10k×10k city-block raster
    stays in seconds.
    """
    labeled, num = _label_components(binary)
    contours: List[np.ndarray] = []
    h, w = binary.shape
    if num == 0:
        return contours

    # start pixel per component = first occurrence in row-major order
    # (topmost, then leftmost — entering from the left), all components
    # in ONE pass
    flat = labeled.ravel()
    nz = np.nonzero(flat)[0]
    comp_of = flat[nz]
    first = np.full(num + 1, -1, np.int64)
    # reversed so earlier indices overwrite later ones
    first[comp_of[::-1]] = nz[::-1]

    lab = labeled  # local alias for the hot loop

    for comp in range(1, num + 1):
        start = first[comp]
        sy, sx = divmod(int(start), w)

        # isolated pixel fast check
        y0, y1 = max(0, sy - 1), min(h, sy + 2)
        x0, x1 = max(0, sx - 1), min(w, sx + 2)
        if np.count_nonzero(lab[y0:y1, x0:x1] == comp) == 1:
            contours.append(np.array([[sx, sy]], np.int32))
            continue

        contour = [(sx, sy)]
        b = 4  # backtrack starts West of the start pixel
        cx, cy = sx, sy
        first_move = None
        while True:
            found = False
            for t in range(8):
                d = (b + 1 + t) % 8
                nx, ny = cx + _MOORE[d][0], cy + _MOORE[d][1]
                if 0 <= nx < w and 0 <= ny < h and lab[ny, nx] == comp:
                    b = (d + 4) % 8
                    cx, cy = nx, ny
                    found = True
                    move = d
                    break
            if not found:
                break  # isolated pixel (already handled) — safety
            if (cx, cy) == (sx, sy) and (first_move is None or move == first_move):
                if first_move is None:
                    first_move = move
                else:
                    break
            if first_move is None:
                first_move = move
            if len(contour) > 4 * (h * w):
                break  # safety bound
            if (cx, cy) == (sx, sy):
                break
            contour.append((cx, cy))

        pts = np.array(contour, np.int32)
        contours.append(_compress_collinear(pts))
    return contours


def _compress_collinear(pts: np.ndarray) -> np.ndarray:
    """Drop interior points of straight (incl. diagonal) runs."""
    if len(pts) <= 2:
        return pts
    keep = [0]
    for i in range(1, len(pts) - 1):
        d0 = pts[i] - pts[keep[-1]]
        d1 = pts[i + 1] - pts[i]
        # same unit direction → collinear run continues
        if not (np.sign(d0[0]) == np.sign(d1[0]) and np.sign(d0[1]) == np.sign(d1[1]) and d0[0] * d1[1] == d0[1] * d1[0]):
            keep.append(i)
    keep.append(len(pts) - 1)
    return pts[keep]


def contour_area(pts: np.ndarray) -> float:
    """OpenCV ``contourArea``: |shoelace| / 2 over the closed polygon."""
    x, y = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    return abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)) / 2.0


def contour_perimeter(pts: np.ndarray) -> float:
    """OpenCV ``arcLength(closed=True)``: closed polyline length."""
    d = pts - np.roll(pts, 1, axis=0)
    return float(np.sum(np.hypot(d[:, 0], d[:, 1])))


def _draw_contour(img: np.ndarray, pts: np.ndarray, color, thickness: int = 2):
    """Rasterize the closed polyline with a square brush (≈ cv line w=2)."""
    h, w = img.shape[:2]
    r = thickness // 2
    for i in range(len(pts)):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % len(pts)]
        steps = int(max(abs(int(x1) - int(x0)), abs(int(y1) - int(y0)), 1))
        for t in range(steps + 1):
            x = int(round(x0 + (int(x1) - int(x0)) * t / steps))
            y = int(round(y0 + (int(y1) - int(y0)) * t / steps))
            img[max(0, y - r) : min(h, y + r + 1), max(0, x - r) : min(w, x + r + 1)] = color


def extract_contours(
    image_rgb: np.ndarray,
    *,
    threshold: float = 10.0,
    min_area: float = 500.0,
    min_perimeter: float = 100.0,
    close_iterations: int = 2,
):
    """Channel-1 threshold → close → trace → filter.

    Returns (all_contours, filtered_contours, result_image).
    """
    green = image_rgb[:, :, 1]
    binary = green > threshold  # THRESH_BINARY at 10 (my_function.cpp:20)
    closed = morphology_close(binary, iterations=close_iterations)
    contours = trace_external_contours(closed)
    filtered = [
        c
        for c in contours
        if contour_area(c) > min_area and contour_perimeter(c) > min_perimeter
    ]
    result = image_rgb.copy()
    for c in filtered:
        _draw_contour(result, c, (255, 255, 0))  # cyan in BGR ≈ (255,255,0)
    return contours, filtered, result


def extracted_contour(
    read_path: str,
    save_path: str,
    flip_path: str,
    obj_path: str = "csa.obj",
    **kwargs,
) -> None:
    """File-level equivalent of the reference's ``extracted_contour``.

    Reads the density PNG, writes the contour overlay, its vertical
    flip, and the extruded OBJ (of ALL contours, like the reference,
    my_function.cpp:79).
    """
    img = read_png(read_path)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    contours, filtered, result = extract_contours(img[:, :, :3], **kwargs)
    write_png(save_path, result)
    write_png(flip_path, result[::-1])
    write_prism_obj(obj_path, contours, img.shape[1], img.shape[0])
