"""OBJ prism writer — extrudes 2-D building contours to 3-D prisms.

The port's copy of ``buildingsegment_tpu/io/obj.py``: the OBJ emission
of the reference's contour stage (tmc3/my_function.cpp:63-126).  Every
2-D contour vertex produces two OBJ vertices (z=0 and z=height), xy
normalized to [0, 1] with the y axis flipped (image rows grow
downward); faces are the side-wall quads only — like the reference, no
top/bottom caps.  The reference extrudes ALL contours, not just the
area/perimeter-filtered ones (loop over ``contours`` at
tmc3/my_function.cpp:79); callers choose which list to pass.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

__all__ = ["prism_obj_text", "write_prism_obj"]


def prism_obj_text(
    contours: Iterable[np.ndarray],
    image_width: int,
    image_height: int,
    height: float = 1.0,
) -> str:
    """Build OBJ text for extruded contour prisms.

    Args:
        contours: iterable of int/float arrays [M, 2] of (x, y) pixel
            coordinates.
        image_width/image_height: raster dims used for normalization.
        height: extrusion height (reference hard-codes 1,
            tmc3/my_function.cpp:101).
    """
    contours = list(contours)
    lines = [
        "# extruded building contours",
        f"# contour count: {len(contours)}",
        "# xy normalized to [0,1]",
        "",
    ]
    vertex_index = 1  # OBJ indices are 1-based
    groups = []
    for contour in contours:
        pts = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
        group = []
        for x, y in pts:
            nx = x / image_width
            ny = 1.0 - y / image_height  # flip y (tmc3/my_function.cpp:87)
            lines.append(f"v {_fmt(nx)} {_fmt(ny)} 0.0")
            group.append(vertex_index)
            vertex_index += 1
            lines.append(f"v {_fmt(nx)} {_fmt(ny)} {_fmt(height)}")
            group.append(vertex_index)
            vertex_index += 1
        groups.append(group)

    lines.append("")
    lines.append("# faces (side-wall quads)")
    for group in groups:
        n = len(group) // 2
        for i in range(n):
            nxt = (i + 1) % n
            bottom1, top1 = group[i * 2], group[i * 2 + 1]
            bottom2, top2 = group[nxt * 2], group[nxt * 2 + 1]
            lines.append(f"f {bottom1} {bottom2} {top2} {top1}")
    return "\n".join(lines) + "\n"


def write_prism_obj(
    path: str,
    contours: Sequence[np.ndarray],
    image_width: int,
    image_height: int,
    height: float = 1.0,
) -> None:
    with open(path, "w") as f:
        f.write(prism_obj_text(contours, image_width, image_height, height))


def _fmt(v: float) -> str:
    # C++ default ostream float formatting (6 significant figures)
    return f"{v:.6g}"
