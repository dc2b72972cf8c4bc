"""The port's native host codec (``native/binding.py``, built with g++ at
first use) against the numpy codec, byte for byte, and against the JAX
package's codec.

* ``write_ply`` through the native codec writes the numpy codec's bytes
  (``write_ply_bytes``), attributes and all, and the JAX package's;
* ``read_ply`` through it gives the numpy codec's arrays
  (``read_ply_bytes``) on binary little- and big-endian and ascii files,
  with and without attributes;
* a file the native codec declines (a short ascii line) goes to the numpy
  codec, which raises the format's error;
* the PNG defilter equals ``defilter_numpy`` on every filter type;
* ``native_calls`` counts each call into the library;
* without a compiler the numpy codec serves (``native_available`` is
  False); a compiler that fails raises.
"""

import struct
import zlib

import numpy as np
import pytest

from buildingsegment_tpu.io.ply import (
    HostPointCloud as JaxHostPointCloud,
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


def test_declined_file_takes_numpy_codec(tmp_path):
    text = (b"ply\nformat ascii 1.0\nelement vertex 2\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"end_header\n1 2 3\n4 5\n")
    path = tmp_path / "short.ply"
    path.write_bytes(text)
    with pytest.raises(PlyError):
        read_ply_bytes(text)
    with pytest.raises(PlyError):
        read_ply(str(path))
    with pytest.raises(FileNotFoundError):
        read_ply(str(tmp_path / "missing.ply"))


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
