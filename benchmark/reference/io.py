"""The benchmark's own file formats: the input PLY it writes, and plain
numpy readers of the PLYs and PNGs the port writes."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
}


def write_input_ply(path: str, mm: np.ndarray) -> None:
    """A scan as a scanner's export holds it: binary little-endian float
    x, y, z in metres.  Each coordinate is written as (mm + 0.5) / 1000,
    so that the reader's ×1000 truncated toward zero (tmc3/ply.cpp:407)
    gives back the integer millimetre exactly."""
    xyz = ((mm.astype(np.float64) + 0.5) / 1000.0).astype("<f4")
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {mm.shape[0]}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "end_header\n").encode()
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(xyz).tobytes())


def read_ply_vertices(path: str) -> dict:
    """The vertex properties of a binary little-endian PLY, by name."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    lines = data[:end].decode("ascii").splitlines()
    if lines[0] != "ply" or lines[1] != "format binary_little_endian 1.0":
        raise ValueError(f"{path}: not a binary little-endian PLY")
    count, fields, in_vertex = 0, [], False
    for line in lines[2:]:
        tok = line.split()
        if tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            fields.append((tok[2], _PLY_TYPES[tok[1]]))
    rows = np.frombuffer(data, np.dtype(fields), count=count, offset=end)
    return {name: rows[name].copy() for name, _ in fields}


def read_input_mm(path: str) -> np.ndarray:
    """int32[n, 3] mm as the reference CLI reads a scan: value × 1000,
    truncated toward zero (tmc3/TMC3.cpp:207, ply.cpp:407-409)."""
    v = read_ply_vertices(path)
    return np.stack([np.trunc(v[a].astype(np.float64) * 1000.0)
                     for a in "xyz"], axis=1).astype(np.int32)


def read_png(path: str) -> np.ndarray:
    """uint8[H, W, C] pixels of an 8-bit, non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype, _c, _f, interlace = struct.unpack(">IIBBBBB",
                                                                  body)
            if depth != 8 or interlace:
                raise ValueError(f"{path}: only 8-bit non-interlaced")
            c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        up = out[y - 1] if y else np.zeros(w * c, np.int32)
        if kind == 0:
            out[y] = line
        elif kind == 2:
            out[y] = (line + up) & 255
        else:  # Sub, Average, Paeth: left to right
            row = np.zeros(w * c, np.int32)
            for x in range(w * c):
                a = row[x - c] if x >= c else 0
                b = up[x]
                cc = up[x - c] if x >= c else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else cc)
                row[x] = (line[x] + pred) & 255
            out[y] = row
    return out.astype(np.uint8).reshape(h, w, c)
