"""ctypes bindings of the native host codec (``ply_codec.cpp``).

The port's copy of ``buildingsegment_tpu/native/binding.py``.  At first
use the library is built with ``g++ -O2 -shared -fPIC`` into the
package's ``_build/`` directory, named by a hash of the source and the
flags (an edited source rebuilds), and loaded with ``ctypes``.

A machine with no C++ compiler keeps the numpy codec
(:func:`native_available` is False there).  Where a compiler exists, a
failed build or load raises: it is a fault, not a reason to switch
codecs.  The codec declines, by a nonzero return, only what the numpy
codec reads or rejects with the format's own error (an unreadable file,
a header it does not parse, no float x, y and z, a short ascii line);
the callers in ``io/ply.py`` and ``io/png.py`` then take the numpy
codec.

:data:`native_calls` counts the calls into the library by entry point
(each decode, encode or defilter), as ``kernels.launch_counts`` counts
kernel launches; ``read_ply_declined`` counts the reads the library
declined, which the numpy codec then took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = [
    "native_available",
    "native_calls",
    "reset_native_calls",
    "read_ply_native",
    "write_ply_native",
    "png_defilter_native",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "ply_codec.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

#: entry point → calls into the library since the last reset
native_calls = {"read_ply": 0, "read_ply_declined": 0, "write_ply": 0,
                "png_defilter": 0}

_lib = None
_lock = threading.Lock()
_I32P = ctypes.POINTER(ctypes.c_int32)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def reset_native_calls() -> None:
    for k in native_calls:
        native_calls[k] = 0


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++")


def _library_path(cxx: str) -> str:
    h = hashlib.sha256(" ".join((os.path.basename(cxx),) + _FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libbst_native_{h.hexdigest()[:16]}.so")


def _build(cxx: str) -> str:
    """Compile the codec unless this source and these flags have a
    library already; returns its path."""
    path = _library_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *_FLAGS, "-o", tmp, _SOURCE],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"native codec: {cxx} failed "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    """The bound library, built at first use; None without a compiler."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = _compiler()
        if cxx is None:
            return None
        lib = ctypes.CDLL(_build(cxx))
        lib.bst_ply_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), _I32P,
        ]
        lib.bst_ply_info.restype = ctypes.c_int
        lib.bst_ply_read.argtypes = [
            ctypes.c_char_p, ctypes.c_double, _I32P, _U16P, _U16P, _U8P,
            _I32P,
        ]
        lib.bst_ply_read.restype = ctypes.c_int
        lib.bst_ply_write.argtypes = [
            ctypes.c_char_p, _I32P, _U16P, _U16P, _U8P, _I32P,
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
        ]
        lib.bst_ply_write.restype = ctypes.c_int
        lib.bst_png_defilter.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _U8P,
        ]
        lib.bst_png_defilter.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """True where the codec is (or can be) built: a C++ compiler exists."""
    return _load() is not None


def _ptr(arr, ctype):
    return None if arr is None else arr.ctypes.data_as(ctypes.POINTER(ctype))


def png_defilter_native(
    raw: bytes, h: int, stride: int, bpp: int
) -> Optional[np.ndarray]:
    """Defilter ``h`` PNG scanlines (filters 0-4) → uint8[h, stride];
    None without the library or on a filter tag outside 0-4."""
    lib = _load()
    if lib is None:
        return None
    rawb = np.frombuffer(raw, np.uint8)
    if rawb.size < h * (stride + 1):
        return None
    out = np.empty((h, stride), np.uint8)
    native_calls["png_defilter"] += 1
    rc = lib.bst_png_defilter(_ptr(rawb, ctypes.c_uint8), h, stride, bpp,
                              _ptr(out, ctypes.c_uint8))
    return out if rc == 0 else None


def read_ply_native(path: str, position_scale: float = 1.0):
    """A PLY through the native codec → HostPointCloud, or None where the
    codec declines the file (or there is no library)."""
    lib = _load()
    if lib is None:
        return None
    count = ctypes.c_int64(0)
    flags = ctypes.c_int32(0)
    if lib.bst_ply_info(path.encode(), ctypes.byref(count),
                        ctypes.byref(flags)) != 0:
        native_calls["read_ply_declined"] += 1
        return None
    n = count.value
    rows = max(n, 1)

    def column(bit, shape, dtype):
        return np.zeros(shape, dtype) if flags.value & bit else None

    pos = np.zeros((rows, 3), np.int32)
    col = column(1, (rows, 3), np.uint16)
    refl = column(2, (rows,), np.uint16)
    fi = column(4, (rows,), np.uint8)
    la = column(8, (rows,), np.int32)
    native_calls["read_ply"] += 1
    rc = lib.bst_ply_read(
        path.encode(), position_scale, _ptr(pos, ctypes.c_int32),
        _ptr(col, ctypes.c_uint16), _ptr(refl, ctypes.c_uint16),
        _ptr(fi, ctypes.c_uint8), _ptr(la, ctypes.c_int32),
    )
    if rc != 0:
        native_calls["read_ply_declined"] += 1
        return None
    from buildingsegment_tpu_torch.io.ply import HostPointCloud

    def cut(a):
        return None if a is None else a[:n]

    return HostPointCloud(positions=pos[:n], colors=cut(col),
                          reflectances=cut(refl), frame_idx=cut(fi),
                          laser_angles=cut(la))


def write_ply_native(
    cloud,
    path: str,
    position_scale: float = 1.0,
    position_offset=(0.0, 0.0, 0.0),
) -> bool:
    """A binary PLY through the native codec, byte for byte the numpy
    codec's; False where it declines (or there is no library)."""
    lib = _load()
    if lib is None:
        return False

    def arr(a, dtype):
        return None if a is None else np.ascontiguousarray(a, dtype)

    pos = np.ascontiguousarray(cloud.positions, np.int32)
    col = arr(cloud.colors, np.uint16)
    refl = arr(cloud.reflectances, np.uint16)
    fi = arr(cloud.frame_idx, np.uint8)
    la = arr(cloud.laser_angles, np.int32)
    native_calls["write_ply"] += 1
    rc = lib.bst_ply_write(
        path.encode(), _ptr(pos, ctypes.c_int32), _ptr(col, ctypes.c_uint16),
        _ptr(refl, ctypes.c_uint16), _ptr(fi, ctypes.c_uint8),
        _ptr(la, ctypes.c_int32), pos.shape[0], position_scale,
        float(position_offset[0]), float(position_offset[1]),
        float(position_offset[2]),
    )
    return rc == 0
