"""Morton (Z-order) sort of the shifted cloud, and the label unsort.

Port of ``buildingsegment_tpu/core/morton.py``.  The code words are the
JAX package's — 10 bits per axis interleaved into 30-bit int32 words —
but the sort runs on int64 keys, which the card sorts natively: the
small-extent branch is ONE stable sort on ``hi << 30 | lo``; the general
branch (90 bits, too wide for one int64) is a stable sort on
``hi << 30 | lo`` followed by a stable sort on the residual word.  Both
give exactly JAX's ``lax.sort`` permutation (ties keep index order).
"""

from __future__ import annotations

import torch

__all__ = [
    "morton_encode",
    "morton_decode",
    "morton_sort",
    "unsort_labels",
    "WORD_BITS",
    "TOTAL_BITS",
]

#: bits per axis captured by one 30-bit int32 word
WORD_BITS = 10
#: total bits per axis across the two-word code
TOTAL_BITS = 2 * WORD_BITS
_BIG = 0x7FFFFFFF


def _spread_bits_10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` so bit i moves to bit 3*i."""
    x = x.to(torch.int32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _unspread_bits_10(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_spread_bits_10`: collect bits 3i → bit i."""
    x = x.to(torch.int32) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def morton_encode(positions: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """30-bit Morton code int32[N] of bits [shift, shift+10) per axis
    (x at bit 3k, y at 3k+1, z at 3k+2)."""
    p = positions >> shift if shift else positions
    x = _spread_bits_10(p[..., 0])
    y = _spread_bits_10(p[..., 1])
    z = _spread_bits_10(p[..., 2])
    return x | (y << 1) | (z << 2)


def morton_decode(code: torch.Tensor) -> torch.Tensor:
    """The three 10-bit axis words of a 30-bit Morton code, int32[N, 3]."""
    return torch.stack(
        [
            _unspread_bits_10(code),
            _unspread_bits_10(code >> 1),
            _unspread_bits_10(code >> 2),
        ],
        dim=-1,
    )


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def morton_sort(
    positions: torch.Tensor, mask: torch.Tensor, small_extent: bool = False
):
    """Sort int32[N, 3] positions + mask by the Morton code.

    ``small_extent=True`` declares every unmasked coordinate < 2^20
    (the pipeline proves it from the host bbox); the residual word is
    then zero and the sort is one int64 key.  Padding sorts last and
    gets ``1 << 24`` sentinel coordinates.

    Returns (sorted positions int32[N, 3], sorted mask bool[N],
    order int64[N] mapping sorted row → original row).
    """
    p = torch.clamp_min(positions, 0)
    if small_extent:
        lo = morton_encode(p, shift=0)
        hi = torch.where(mask, morton_encode(p, shift=WORD_BITS), _BIG)
        order = _stable_order((hi.to(torch.int64) << 30) | lo.to(torch.int64))
        s_hi, s_lo = hi[order], lo[order]
        m = s_hi < _BIG
        spos = morton_decode(s_lo) | (morton_decode(s_hi) << WORD_BITS)
        spos = torch.where(m[:, None], spos, 1 << 24)
        return spos, m, order
    low = p & ((1 << TOTAL_BITS) - 1)
    lo = morton_encode(low, shift=0)
    hi = morton_encode(low, shift=WORD_BITS)
    # bits ≥ 20 per axis as the LEADING key (coarse cell first)
    resid = (
        (p[:, 0] >> TOTAL_BITS)
        | ((p[:, 1] >> TOTAL_BITS) << WORD_BITS)
        | ((p[:, 2] >> TOTAL_BITS) << (2 * WORD_BITS))
    )
    resid = torch.where(mask, resid, _BIG)
    # LSD order: the minor keys first, then a stable pass on the major
    order = _stable_order((hi.to(torch.int64) << 30) | lo.to(torch.int64))
    order = order[_stable_order(resid[order])]
    s_res, s_hi, s_lo = resid[order], hi[order], lo[order]
    m = s_res < _BIG
    res_axes = torch.stack(
        [
            s_res & 0x3FF,
            (s_res >> WORD_BITS) & 0x3FF,
            (s_res >> (2 * WORD_BITS)) & 0x3FF,
        ],
        dim=-1,
    )
    spos = (
        morton_decode(s_lo)
        | (morton_decode(s_hi) << WORD_BITS)
        | (res_axes << TOTAL_BITS)
    )
    spos = torch.where(m[:, None], spos, 1 << 24)
    return spos, m, order


def unsort_labels(order: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Labels back in the original row order: ``out[order] = labels``."""
    out = torch.empty_like(labels)
    out[order] = labels
    return out
