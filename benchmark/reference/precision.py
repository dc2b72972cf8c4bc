"""The control's arithmetic: the reference with TF32 products.

The configurations state float32 geometry with TF32 off, so the control
is the reference computed as a TF32 tensor-core kernel computes: every
operand of a product rounded to TF32 (10 explicit mantissa bits, to
nearest, ties to even), the products and their sums kept in float32.
Inside :func:`tf32_products` the reference rounds so at each point that
such a kernel would: stage 1's distances, moments and covariance, the
solve's segment sums (a sum by id is a product with a one-hot matrix),
and the raster's splat sums.  Outside, :func:`rp` returns its operand
unchanged.
"""

from __future__ import annotations

import contextlib

import torch

_ON = [False]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits."""
    b = x.float().contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return (((b + 0xFFF + lsb) >> 13) << 13).view(torch.float32)


def active() -> bool:
    """Whether the reference runs as the control."""
    return _ON[0]


def rp(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product: rounded to TF32 inside
    :func:`tf32_products` (float32 out), unchanged outside."""
    return tf32_round(x) if _ON[0] else x


@contextlib.contextmanager
def tf32_products():
    """Run the reference inside the block as the control."""
    _ON[0] = True
    try:
        yield
    finally:
        _ON[0] = False
