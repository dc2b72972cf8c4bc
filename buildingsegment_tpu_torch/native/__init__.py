"""The native host codec of the port: PLY read/write and the PNG
defilter in C++ (``ply_codec.cpp``), built with g++ at first use and
bound with ctypes (``binding.py``)."""

from buildingsegment_tpu_torch.native.binding import (
    native_available,
    native_calls,
    png_defilter_native,
    read_ply_native,
    reset_native_calls,
    write_ply_native,
)

__all__ = [
    "native_available",
    "native_calls",
    "png_defilter_native",
    "read_ply_native",
    "reset_native_calls",
    "write_ply_native",
]
