"""PLY codec — vectorized numpy reader/writer, reference-exact semantics.

The port's copy of ``buildingsegment_tpu/io/ply.py``.  ``read_ply`` and
binary ``write_ply`` go through the native C++ codec
(``native/binding.py``, built with g++ at first use) where a compiler
exists, as in the JAX package; the numpy codec below
(``read_ply_bytes``, ``write_ply_bytes``: binary bodies through one
structured numpy array) is the plain version, byte for byte the same
output, and reads what the native codec declines.

Re-implements the behavior of the reference's stream parser/serializer
(tmc3/ply.cpp:88-504) with numpy bulk decoding instead of a per-point
``ifs.read`` loop.  Parity-critical semantics preserved:

Reader (tmc3/ply.cpp:190-504):
  * header: ascii / binary_little_endian / binary_big_endian, version 1.0
    only; ``comment`` lines skipped; properties after a non-vertex
    ``element`` line are ignored (tmc3/ply.cpp:254-263).
  * positions: any of float32/float64 accepted; value × positionScale
    truncated **toward zero** into int32 (tmc3/ply.cpp:407-409 — C++
    double→int32_t conversion).
  * colors: only uint8 ``red``/``green``/``blue`` recognized; stored
    internally in (g, b, r) channel order (tmc3/ply.cpp:412-414 ascii,
    466-477 binary).
  * reflectance (``reflectance``/``refc``, ≤2 bytes), ``frameindex``
    (≤2 bytes, stored as uint8), ``laserangle`` (rounded) supported.
  * unknown properties skipped byte-wise (tmc3/ply.cpp:496-499).

Writer (tmc3/ply.cpp:88-186):
  * header: positions declared ``property float`` when ascii and
    ``property float64`` when binary (tmc3/ply.cpp:116-124); colors
    declared in header order green, blue, red (tmc3/ply.cpp:126-130) —
    matching the internal storage order so bytes are written verbatim;
    trailing ``element face 0`` + list property (tmc3/ply.cpp:137-138).
  * positions written as ``int_pos × scale + offset`` float64 (binary)
    or fixed-precision-5 text (ascii, tmc3/ply.cpp:142).
  * binary body: raw little-endian double[3] + uint8[3] colors
    (+ uint16 refc, uint16 frameindex) per point (tmc3/ply.cpp:164-182).
"""

from __future__ import annotations

import dataclasses
import io as _io
from typing import Optional

import numpy as np

__all__ = ["HostPointCloud", "read_ply", "write_ply", "PlyError"]


class PlyError(ValueError):
    pass


@dataclasses.dataclass
class HostPointCloud:
    """Host-side mirror of the device PointBatch (numpy, unpadded).

    ``colors`` uses the reference's internal (green, blue, red) channel
    order (tmc3/ply.cpp:412-414).
    """

    positions: np.ndarray  # int32[N, 3]
    colors: Optional[np.ndarray] = None  # uint16[N, 3] (g, b, r)
    reflectances: Optional[np.ndarray] = None  # uint16[N]
    frame_idx: Optional[np.ndarray] = None  # uint8[N]
    laser_angles: Optional[np.ndarray] = None  # int32[N]
    plane_idx: Optional[np.ndarray] = None  # int32[N] (not serialized)

    @property
    def count(self) -> int:
        return int(self.positions.shape[0])

    def select(self, keep: np.ndarray) -> "HostPointCloud":
        """Row-subset copy (boolean mask or index array) across every
        present attribute — the host analog of the reference's
        container resize after dedup (tmc3/PCCPointSet.h:457-472)."""
        pick = lambda a: None if a is None else a[keep]
        return HostPointCloud(
            positions=self.positions[keep],
            colors=pick(self.colors),
            reflectances=pick(self.reflectances),
            frame_idx=pick(self.frame_idx),
            laser_angles=pick(self.laser_angles),
            plane_idx=pick(self.plane_idx),
        )


# PLY property type name → numpy dtype (little-endian base; byte order
# applied at decode time).  Mirrors the accepted set at
# tmc3/ply.cpp:275-305.
_TYPE_MAP = {
    "float64": "f8",
    "double": "f8",
    "float": "f4",
    "float32": "f4",
    "uint64": "u8",
    "uint32": "u4",
    "uint16": "u2",
    "uchar": "u1",
    "uint8": "u1",
    "int64": "i8",
    "int32": "i4",
    "int16": "i2",
    "char": "i1",
    "int8": "i1",
}


def _tokens(line: bytes) -> list:
    return line.decode("ascii", errors="replace").replace("\t", " ").replace("\r", " ").split()


def read_ply(
    path: str,
    position_scale: float = 1.0,
    position_names: tuple = ("x", "y", "z"),
) -> HostPointCloud:
    """Read a PLY file with reference-exact mapping semantics: the native
    codec for the default x/y/z names, the numpy codec for other names
    and for what the native codec declines."""
    if position_names == ("x", "y", "z"):
        from buildingsegment_tpu_torch.native.binding import read_ply_native

        out = read_ply_native(path, position_scale)
        if out is not None:
            return out
    with open(path, "rb") as f:
        data = f.read()
    return read_ply_bytes(data, position_scale, position_names)


def read_ply_bytes(
    data: bytes,
    position_scale: float = 1.0,
    position_names: tuple = ("x", "y", "z"),
) -> HostPointCloud:
    stream = _io.BytesIO(data)

    line = stream.readline()
    if not _tokens(line) or _tokens(line)[0] != "ply":
        raise PlyError("corrupted file: missing 'ply' magic")

    is_ascii = False
    big_endian = False
    version = 1.0
    point_count = 0
    in_vertex_element = True
    props = []  # (name, type_char) for the vertex element only

    while True:
        line = stream.readline()
        if not line:
            raise PlyError("corrupted header: EOF before end_header")
        toks = _tokens(line)
        if not toks or toks[0] == "comment":
            continue
        if toks[0] == "format":
            if len(toks) != 3:
                raise PlyError("corrupted format info")
            is_ascii = toks[1] == "ascii"
            big_endian = toks[1] == "binary_big_endian"
            version = float(toks[2])
        elif toks[0] == "element":
            if len(toks) != 3:
                raise PlyError("corrupted element info")
            if toks[1] == "vertex":
                point_count = int(toks[2])
                in_vertex_element = True
            else:
                in_vertex_element = False
        elif toks[0] == "property" and in_vertex_element:
            # robustness extension: vertex-element list properties (from
            # meshing tools) are tolerated and skipped.  The reference
            # errors out on them ("corrupted property info",
            # tmc3/ply.cpp:264-268 requires exactly 3 tokens) — we
            # accept the file and ignore the data.
            if len(toks) == 5 and toks[1] == "list":
                # common meshing-tool aliases accepted here only
                alias = {"int": "i4", "uint": "u4", "short": "i2",
                         "ushort": "u2", **_TYPE_MAP}
                if toks[2] not in alias or toks[3] not in alias:
                    raise PlyError("unknown list property type")
                props.append(
                    (toks[4], ("list", alias[toks[2]], alias[toks[3]]))
                )
                continue
            if len(toks) != 3:
                raise PlyError("corrupted property info")
            type_name, prop_name = toks[1], toks[2]
            if type_name not in _TYPE_MAP:
                raise PlyError(f"unknown property type {type_name!r}")
            props.append((prop_name, _TYPE_MAP[type_name]))
        elif toks[0] == "end_header":
            break
    if version != 1.0:
        raise PlyError("non-supported version")

    names = [p[0] for p in props]
    has_lists = any(isinstance(dt, tuple) for _, dt in props)
    # scalar column index per property (list props occupy no column)
    scalar_col = {}
    for i, (_, dt) in enumerate(props):
        if not isinstance(dt, tuple):
            scalar_col[i] = len(scalar_col)

    def find(name, pred=lambda dt: True):
        for i, (n, dt) in enumerate(props):
            if isinstance(dt, tuple):
                continue  # skipped list property
            if n == name and pred(dt):
                return i
        return None

    is_float = lambda dt: dt in ("f4", "f8")
    ix = find(position_names[0], is_float)
    iy = find(position_names[1], is_float)
    iz = find(position_names[2], is_float)
    if ix is None or iy is None or iz is None:
        raise PlyError("missing coordinates")
    ir = find("red", lambda dt: dt == "u1")
    ig = find("green", lambda dt: dt == "u1")
    ib = find("blue", lambda dt: dt == "u1")
    irefl = find("reflectance", lambda dt: dt in ("u1", "u2", "i1", "i2"))
    if irefl is None:
        irefl = find("refc", lambda dt: dt in ("u1", "u2", "i1", "i2"))
    iframe = find("frameindex", lambda dt: dt in ("u1", "u2", "i1", "i2"))
    ilaser = find("laserangle")

    with_colors = ir is not None and ig is not None and ib is not None

    if is_ascii:
        if has_lists:
            table = _read_ascii_body_with_lists(stream, point_count, props)
        else:
            table = _read_ascii_body(stream, point_count, len(props))
        get = lambda i: table[:, scalar_col[i]]
    elif has_lists:
        table = _read_binary_body_with_lists(
            stream.read(), point_count, props, ">" if big_endian else "<"
        )
        get = lambda i: table[:, scalar_col[i]]
    else:
        order = ">" if big_endian else "<"
        rec_dtype = np.dtype(
            [(f"p{i}", order + dt) for i, (_, dt) in enumerate(props)]
        )
        body = stream.read()
        n_avail = min(point_count, len(body) // rec_dtype.itemsize)
        recs = np.frombuffer(body, dtype=rec_dtype, count=n_avail)
        if n_avail < point_count:
            # reference tolerates truncated bodies (loop guard !ifs.eof(),
            # tmc3/ply.cpp:431) — remaining points stay zero
            pad = np.zeros(point_count - n_avail, dtype=rec_dtype)
            recs = np.concatenate([recs, pad])
        get = lambda i: recs[f"p{i}"]

    # value × scale truncated toward zero → int32 (tmc3/ply.cpp:407-409)
    positions = np.stack(
        [
            np.trunc(get(ix).astype(np.float64) * position_scale),
            np.trunc(get(iy).astype(np.float64) * position_scale),
            np.trunc(get(iz).astype(np.float64) * position_scale),
        ],
        axis=1,
    ).astype(np.int32)

    colors = None
    if with_colors:
        # internal order (g, b, r) — tmc3/ply.cpp:412-414
        colors = np.stack(
            [get(ig), get(ib), get(ir)], axis=1
        ).astype(np.uint16)

    reflectances = (
        get(irefl).astype(np.uint16) if irefl is not None else None
    )
    frame_idx = get(iframe).astype(np.uint8) if iframe is not None else None
    laser_angles = (
        np.round(get(ilaser).astype(np.float64)).astype(np.int32)
        if ilaser is not None
        else None
    )

    return HostPointCloud(
        positions=positions,
        colors=colors,
        reflectances=reflectances,
        frame_idx=frame_idx,
        laser_angles=laser_angles,
    )


def _read_ascii_body_with_lists(
    stream: _io.BytesIO, point_count: int, props: list
) -> np.ndarray:
    """Slow path: per-row token walk skipping list properties.

    Only used for the rare vertex element carrying list properties —
    a robustness extension beyond the reference (which errors out)."""
    n_scalar = sum(1 for _, dt in props if not isinstance(dt, tuple))
    table = np.zeros((point_count, n_scalar), dtype=np.float64)
    row = 0
    while row < point_count:
        line = stream.readline()
        if not line:
            break
        toks = _tokens(line)
        if not toks:
            continue
        t = 0
        col = 0
        try:
            for _, dt in props:
                if isinstance(dt, tuple):
                    cnt = int(float(toks[t]))
                    t += 1 + cnt
                else:
                    table[row, col] = float(toks[t])
                    t += 1
                    col += 1
        except IndexError:
            raise PlyError("short data line") from None
        row += 1
    return table


def _read_binary_body_with_lists(
    body: bytes, point_count: int, props: list, order: str
) -> np.ndarray:
    """Slow path: per-row offset walk skipping list properties."""
    n_scalar = sum(1 for _, dt in props if not isinstance(dt, tuple))
    table = np.zeros((point_count, n_scalar), dtype=np.float64)
    off = 0
    size = len(body)
    for row in range(point_count):
        col = 0
        for _, dt in props:
            if isinstance(dt, tuple):
                _, cnt_dt, item_dt = dt
                cnt_np = np.dtype(order + cnt_dt)
                if off + cnt_np.itemsize > size:
                    return table  # truncated body tolerated, rest zero
                cnt = int(
                    np.frombuffer(body, cnt_np, count=1, offset=off)[0]
                )
                off += cnt_np.itemsize + cnt * np.dtype(item_dt).itemsize
            else:
                d = np.dtype(order + dt)
                if off + d.itemsize > size:
                    return table
                table[row, col] = np.frombuffer(body, d, count=1, offset=off)[0]
                off += d.itemsize
                col += 1
        if off > size:
            return table
    return table


def _read_ascii_body(stream: _io.BytesIO, point_count: int, n_props: int) -> np.ndarray:
    rows = []
    while len(rows) < point_count:
        line = stream.readline()
        if not line:
            break
        toks = _tokens(line)
        if not toks:
            continue  # blank lines skipped (tmc3/ply.cpp:400-402)
        if len(toks) < n_props:
            raise PlyError("short data line")
        rows.append(toks[:n_props])
    table = np.zeros((point_count, n_props), dtype=np.float64)
    if rows:
        table[: len(rows)] = np.array(rows, dtype=np.float64)
    return table


def write_ply(
    cloud: HostPointCloud,
    path: str,
    position_scale: float = 1.0,
    position_offset: tuple = (0.0, 0.0, 0.0),
    ascii: bool = False,
    position_names: tuple = ("x", "y", "z"),
) -> None:
    """Write a PLY file with the reference's exact header/body layout;
    binary x/y/z clouds through the native codec."""
    if not ascii and position_names == ("x", "y", "z"):
        from buildingsegment_tpu_torch.native.binding import write_ply_native

        if write_ply_native(cloud, path, position_scale, position_offset):
            return
    with open(path, "wb") as f:
        f.write(
            write_ply_bytes(
                cloud, position_scale, position_offset, ascii, position_names
            )
        )


def write_ply_bytes(
    cloud: HostPointCloud,
    position_scale: float = 1.0,
    position_offset: tuple = (0.0, 0.0, 0.0),
    ascii: bool = False,
    position_names: tuple = ("x", "y", "z"),
) -> bytes:
    n = cloud.count
    has_colors = cloud.colors is not None
    has_refl = cloud.reflectances is not None
    has_frame = cloud.frame_idx is not None
    has_laser = cloud.laser_angles is not None

    header = ["ply"]
    if ascii:
        header.append("format ascii 1.0")
        pos_type = "float"
    else:
        header.append("format binary_little_endian 1.0")
        pos_type = "float64"
    header.append(f"element vertex {n}")
    for name in position_names:
        header.append(f"property {pos_type} {name}")
    if has_colors:
        # header channel order green/blue/red matches internal storage
        # (tmc3/ply.cpp:126-130)
        header.append("property uchar green")
        header.append("property uchar blue")
        header.append("property uchar red")
    if has_refl:
        header.append("property uint16 refc")
    if has_frame:
        header.append("property uint8 frameindex")
    if has_laser:
        # extension: the reference CONTAINER round-trips laser angles
        # (tmc3/PCCPointSet.h:604-613) but its writer drops them
        # (tmc3/ply.cpp:126-138 emits only colors/refc/frameindex); we
        # preserve them so a read->write cycle is lossless
        header.append("property int32 laserangle")
    header.append("element face 0")
    header.append("property list uint8 int32 vertex_index")
    header.append("end_header")
    head = ("\n".join(header) + "\n").encode("ascii")

    pos = cloud.positions.astype(np.float64) * position_scale + np.asarray(
        position_offset, dtype=np.float64
    )

    if ascii:
        out = [head]
        cols = [pos[:, 0], pos[:, 1], pos[:, 2]]
        fmt = ["%.5f", "%.5f", "%.5f"]
        if has_colors:
            cols += [cloud.colors[:, 0], cloud.colors[:, 1], cloud.colors[:, 2]]
            fmt += ["%d", "%d", "%d"]
        if has_refl:
            cols += [cloud.reflectances]
            fmt += ["%d"]
        if has_frame:
            cols += [cloud.frame_idx]
            fmt += ["%d"]
        if has_laser:
            cols += [cloud.laser_angles]
            fmt += ["%d"]
        fmt_str = " ".join(fmt)
        lines = "\n".join(
            fmt_str % tuple(vals) for vals in zip(*cols)
        )
        if n:
            out.append(lines.encode("ascii") + b"\n")
        return b"".join(out)

    fields = [("x", "<f8"), ("y", "<f8"), ("z", "<f8")]
    if has_colors:
        fields += [("g", "u1"), ("b", "u1"), ("r", "u1")]
    if has_refl:
        fields += [("refc", "<u2")]
    if has_frame:
        fields += [("fi", "<u2")]  # uint16 on the wire (tmc3/ply.cpp:178-181)
    if has_laser:
        fields += [("la", "<i4")]
    recs = np.zeros(n, dtype=np.dtype(fields))
    recs["x"], recs["y"], recs["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
    if has_colors:
        c = cloud.colors.astype(np.uint8)
        recs["g"], recs["b"], recs["r"] = c[:, 0], c[:, 1], c[:, 2]
    if has_refl:
        recs["refc"] = cloud.reflectances
    if has_frame:
        recs["fi"] = cloud.frame_idx.astype(np.uint16)
    if has_laser:
        recs["la"] = cloud.laser_angles.astype(np.int32)
    return head + recs.tobytes()
