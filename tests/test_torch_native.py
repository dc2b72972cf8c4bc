"""The port's native host codec (``native/binding.py``, built with g++ at
first use) against the numpy codec, byte for byte, and against the JAX
package's codec.

* ``write_ply`` through the native codec writes the numpy codec's bytes
  (``write_ply_bytes``), attributes and all, and the JAX package's;
* ``read_ply`` through it gives the numpy codec's arrays
  (``read_ply_bytes``), and the JAX package's, on binary little- and big-endian and ascii files,
  with and without attributes, over the binary reader's matrix: float and
  double positions in both byte orders, skipped properties, every
  attribute, record counts around the reader's block, values whose ×1000
  lies next to an integer, truncated bodies and duplicate names (the
  first wins);
* a file the native codec declines (a short ascii line, no z) goes to the
  numpy codec, which raises the format's error, and is counted;
* the PNG defilter equals ``defilter_numpy`` on every filter type;
* ``native_calls`` counts each call into the library;
* without a compiler the numpy codec serves (``native_available`` is
  False); a compiler that fails raises.
"""

import re
import struct
import zlib

import numpy as np
import pytest

from benchmark.reference.io import write_input_ply
from buildingsegment_tpu.io.ply import (
    HostPointCloud as JaxHostPointCloud,
    read_ply_bytes as jax_read_ply_bytes,
    write_ply_bytes as jax_write_ply_bytes,
)
from buildingsegment_tpu_torch.io import png
from buildingsegment_tpu_torch.io.ply import (
    HostPointCloud,
    PlyError,
    read_ply,
    read_ply_bytes,
    write_ply,
    write_ply_bytes,
)
from buildingsegment_tpu_torch.native import binding

_ATTRS = ("positions", "colors", "reflectances", "frame_idx", "laser_angles")


def _cloud(rng, n, attrs, frame=True):
    """A cloud with every attribute (``frame``: the frame index too, which
    the writer puts on the wire as uint16 under a uint8 header, the
    reference's own mismatch, so a file with it does not read back)."""
    kw = dict(positions=rng.integers(-50_000, 50_000, (n, 3)).astype(
        np.int32))
    if attrs:
        kw.update(
            colors=rng.integers(0, 256, (n, 3)).astype(np.uint16),
            reflectances=rng.integers(0, 65_536, n).astype(np.uint16),
            laser_angles=rng.integers(-9_000, 9_000, n).astype(np.int32),
        )
        if frame:
            kw["frame_idx"] = rng.integers(0, 256, n).astype(np.uint8)
    return HostPointCloud(**kw)


def _assert_clouds_equal(b, a):
    for name in _ATTRS:
        va, vb = getattr(a, name), getattr(b, name)
        if va is None:
            assert vb is None, name
        else:
            assert vb.dtype == va.dtype and vb.shape == va.shape, name
            np.testing.assert_array_equal(vb, va, err_msg=name)


def test_native_available():
    assert binding.native_available()


@pytest.mark.parametrize("attrs", [False, True], ids=["xyz", "attributes"])
@pytest.mark.parametrize("scale,offset", [(1.0, (0.0, 0.0, 0.0)),
                                          (0.001, (1.5, -2.0, 0.25))])
def test_write_bytes_equal_numpy_and_jax(rng, tmp_path, attrs, scale, offset):
    cloud = _cloud(rng, 3000, attrs)
    binding.reset_native_calls()
    path = str(tmp_path / "n.ply")
    write_ply(cloud, path, position_scale=scale, position_offset=offset)
    assert binding.native_calls["write_ply"] == 1
    got = open(path, "rb").read()
    assert got == write_ply_bytes(cloud, scale, offset)
    jcloud = JaxHostPointCloud(**{k: getattr(cloud, k) for k in _ATTRS})
    assert got == jax_write_ply_bytes(jcloud, scale, offset)


@pytest.mark.parametrize("attrs", [False, True], ids=["xyz", "attributes"])
def test_read_equals_numpy_binary(rng, tmp_path, attrs):
    cloud = _cloud(rng, 2000, attrs, frame=False)
    data = write_ply_bytes(cloud, 0.001)
    path = tmp_path / "b.ply"
    path.write_bytes(data)
    binding.reset_native_calls()
    got = read_ply(str(path), position_scale=1000.0)
    assert binding.native_calls["read_ply"] == 1
    _assert_clouds_equal(got, read_ply_bytes(data, 1000.0))
    _assert_clouds_equal(got, jax_read_ply_bytes(data, 1000.0))


def test_read_equals_numpy_ascii_and_big_endian(rng, tmp_path):
    raw = rng.uniform(-100, 100, size=(500, 3))
    body = "\n".join(" ".join(f"{v:.7f}" for v in r) + " 7" for r in raw)
    text = ("ply\nformat ascii 1.0\nelement vertex 500\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nend_header\n" + body + "\n").encode()
    head = (b"ply\nformat binary_big_endian 1.0\nelement vertex 500\n"
            b"property float32 x\nproperty float32 y\nproperty float32 z\n"
            b"end_header\n")
    be = head + b"".join(struct.pack(">3f", *r) for r in raw)
    for name, data in (("a.ply", text), ("be.ply", be)):
        path = tmp_path / name
        path.write_bytes(data)
        binding.reset_native_calls()
        got = read_ply(str(path), position_scale=1000.0)
        assert binding.native_calls["read_ply"] == 1, name
        _assert_clouds_equal(got, read_ply_bytes(data, 1000.0))
        _assert_clouds_equal(got, jax_read_ply_bytes(data, 1000.0))


def test_declined_file_takes_numpy_codec(tmp_path):
    text = (b"ply\nformat ascii 1.0\nelement vertex 2\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"end_header\n1 2 3\n4 5\n")
    path = tmp_path / "short.ply"
    path.write_bytes(text)
    with pytest.raises(PlyError):
        read_ply_bytes(text)
    binding.reset_native_calls()
    with pytest.raises(PlyError):
        read_ply(str(path))
    assert binding.native_calls["read_ply"] == 1
    assert binding.native_calls["read_ply_declined"] == 1
    no_z = (b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
            b"property float x\nproperty float y\nend_header\n"
            + struct.pack("<2f", 1.0, 2.0))
    (tmp_path / "no_z.ply").write_bytes(no_z)
    with pytest.raises(PlyError, match="missing coordinates"):
        read_ply(str(tmp_path / "no_z.ply"))
    assert binding.native_calls["read_ply_declined"] == 2
    with pytest.raises(FileNotFoundError):
        read_ply(str(tmp_path / "missing.ply"))
    assert binding.native_calls["read_ply_declined"] == 3
    assert binding.native_calls["read_ply"] == 1


# records the binary reader decodes a block at a time
_BLOCK = int(re.search(r"kBlockRecords = (\d+);",
                       open(binding._SOURCE).read()).group(1))


def _edge_coords(rng, n, dtype):
    """Metres, negative and positive, a third of them the representable
    neighbours of k / 1000, so that ×1000 lies just either side of an
    integer."""
    v = rng.uniform(-60.0, 60.0, n).astype(dtype)
    k = rng.integers(-60_000, 60_000, n) / 1000.0
    near = np.nextafter(k.astype(dtype), np.where(
        rng.random(n) < 0.5, -np.inf, np.inf).astype(dtype))
    return np.where(np.arange(n) % 3 == 0, near, v).astype(dtype)


def _ply(props, n, order, rng, truncate=False):
    """A PLY of ``props`` ((name, numpy type)) in byte order ``order``, or
    ascii for "ascii", its values drawn from ``rng``."""
    byte_order = "<" if order == "ascii" else order
    dt = np.dtype([(f"c{i}", byte_order + t)
                   for i, (_, t) in enumerate(props)])
    recs = np.zeros(n, dt)
    for i, (name, t) in enumerate(props):
        if name in "xyz":
            recs[f"c{i}"] = _edge_coords(rng, n, t)
        elif name == "laserangle":  # ties round half to even
            recs[f"c{i}"] = rng.integers(-400, 400, n) / 2.0
        elif t[0] == "f":
            recs[f"c{i}"] = rng.normal(size=n)
        else:
            info = np.iinfo(t)
            recs[f"c{i}"] = rng.integers(info.min, info.max, n,
                                         endpoint=True, dtype=t)
    fmt = {"<": "binary_little_endian", ">": "binary_big_endian",
           "ascii": "ascii"}[order]
    head = f"ply\nformat {fmt} 1.0\nelement vertex {n}\n" + "".join(
        f"property {_PLY_NAME[t]} {name}\n" for name, t in props)
    if order == "ascii":
        body = "".join(" ".join(str(v) for v in r) + "\n"
                       for r in recs.tolist()).encode()
    else:
        body = recs.tobytes()
    if truncate:  # the last record and a half are cut
        body = body[:max(0, len(body) - dt.itemsize * 3 // 2)]
    return (head + "element face 0\nproperty list uint8 int32 "
            "vertex_index\nend_header\n").encode() + body


_PLY_NAME = {"f4": "float", "f8": "double", "u1": "uchar", "u2": "uint16",
             "i1": "char", "i2": "int16", "i4": "int32", "u4": "uint32",
             "i8": "int64"}

_XYZ = [("x", "P"), ("y", "P"), ("z", "P")]
_LAYOUTS = {
    "xyz": _XYZ,
    "skipped": [("x", "P"), ("nx", "f4"), ("y", "P"), ("flags", "u1"),
                ("z", "P"), ("intensity", "i4"), ("time", "f8"),
                ("id", "u4")],
    "attributes": _XYZ + [("red", "u1"), ("green", "u1"), ("blue", "u1"),
                          ("reflectance", "i2"), ("frameindex", "u2"),
                          ("laserangle", "f4")],
    "x_twice": [("x", "P"), ("y", "P"), ("x", "P"), ("z", "P")],
    "reflectance_then_refc": _XYZ + [("reflectance", "u2"), ("refc", "u1")],
    "refc_then_reflectance": _XYZ + [("refc", "u2"), ("reflectance", "u1"),
                                     ("refc", "u1")],
    "colours_twice": _XYZ + [("blue", "u1"), ("green", "u1"), ("red", "u1"),
                             ("frameindex", "u1"), ("red", "u1"),
                             ("laserangle", "i2"), ("laserangle", "f8"),
                             ("frameindex", "i2")],
}
_B = _BLOCK
_ORDER_ID = {"<": "le", ">": "be", "ascii": "ascii"}
_MATRIX = (
    # the cells' layout (benchmark/reference/io.write_input_ply) at every
    # record count around the block
    [("cells", None, "<", n, False) for n in
     (0, 1, _B - 1, _B, _B + 1, 3 * _B + 7)]
    + [("cells", None, "<", 3 * _B + 7, True)]
    + [(layout, t, o, _B + 1, False)
       for layout in ("xyz", "skipped", "attributes")
       for t in ("f4", "f8") for o in ("<", ">")]
    + [("attributes", "f8", ">", 2 * _B, True),
       ("skipped", "f4", "<", 1, True),
       ("x_twice", "f4", "<", 1000, False),
       ("x_twice", "f8", ">", 1000, False),
       ("x_twice", "f4", "ascii", 50, False),
       ("reflectance_then_refc", "f4", "<", 1000, False),
       ("refc_then_reflectance", "f4", ">", 1000, False),
       ("colours_twice", "f8", "<", 1000, False)]
)


@pytest.mark.parametrize(
    "layout,pos_type,order,n,truncate", _MATRIX,
    ids=[f"{la}-{t or 'f4'}-{_ORDER_ID[o]}-n{n}"
         f"{'-truncated' if tr else ''}" for la, t, o, n, tr in _MATRIX])
def test_read_matrix_equals_numpy(tmp_path, layout, pos_type, order, n,
                                  truncate):
    rng = np.random.default_rng(n + 17 * len(layout))
    path = tmp_path / "m.ply"
    if layout == "cells":
        mm = rng.integers(-40_000, 40_000, (n, 3)).astype(np.int32)
        write_input_ply(str(path), mm)
        data = path.read_bytes()
        if truncate:
            data = data[:len(data) - 18]
            path.write_bytes(data)
    else:
        props = [(name, pos_type if t == "P" else t)
                 for name, t in _LAYOUTS[layout]]
        data = _ply(props, n, order, rng, truncate)
        path.write_bytes(data)
    binding.reset_native_calls()
    got = read_ply(str(path), position_scale=1000.0)
    assert binding.native_calls["read_ply"] == 1
    assert binding.native_calls["read_ply_declined"] == 0
    want = read_ply_bytes(data, 1000.0)
    _assert_clouds_equal(got, want)
    _assert_clouds_equal(got, jax_read_ply_bytes(data, 1000.0))
    if truncate and n:
        assert not want.positions[-1].any()


def _png_scanlines(rng, h, w, c):
    """Raw PNG scanlines with every filter tag 0-4 in turn."""
    img = rng.integers(0, 256, (h, w * c)).astype(np.uint8)
    tags = (np.arange(h) % 5).astype(np.uint8)
    return np.concatenate([tags[:, None], img], 1).tobytes()


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_defilter_equals_numpy(rng, c):
    h, w = 37, 23
    raw = _png_scanlines(rng, h, w, c)
    binding.reset_native_calls()
    got = binding.png_defilter_native(raw, h, w * c, c)
    assert binding.native_calls["png_defilter"] == 1
    np.testing.assert_array_equal(got.reshape(h, w, c),
                                  png.defilter_numpy(raw, h, w, c))


def test_read_png_through_native(rng, tmp_path):
    h, w, c = 19, 11, 3
    raw = _png_scanlines(rng, h, w, c)
    data = (b"\x89PNG\r\n\x1a\n"
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + png._chunk(b"IDAT", zlib.compress(raw))
            + png._chunk(b"IEND", b""))
    path = tmp_path / "f.png"
    path.write_bytes(data)
    binding.reset_native_calls()
    got = png.read_png(str(path))
    assert binding.native_calls["png_defilter"] == 1
    np.testing.assert_array_equal(got, png.defilter_numpy(raw, h, w, c))


def test_no_compiler_keeps_numpy_codec(rng, tmp_path, monkeypatch):
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_compiler", lambda: None)
    assert not binding.native_available()
    cloud = _cloud(rng, 100, True, frame=False)
    binding.reset_native_calls()
    write_ply(cloud, str(tmp_path / "x.ply"))
    _assert_clouds_equal(read_ply(str(tmp_path / "x.ply")),
                         read_ply_bytes(write_ply_bytes(cloud)))
    assert not any(binding.native_calls.values())


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(binding, "_compiler", lambda: "false")
    with pytest.raises(RuntimeError, match="native codec: false failed"):
        binding.native_available()
