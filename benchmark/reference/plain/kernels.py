"""The constants of ``buildingsegment_tpu_torch/kernels.py`` (commit
e8749d5) that the plain paths read: the row blocks their fixed-order
sums use and the 128-id live bound.  No kernel is built or called."""

PAYMOM_ROWS = 1024
ADOPT_ROWS = 256
ADOPT_LANES = 128
SEGSUM_ROWS = 1024
SEGSUM_MAX_COLS = 128
COMPACT_STATS_ROWS = 1024
LOOKUP_COLS_MAX = 8


def ceil128(x: int) -> int:
    """``x`` rounded up to a multiple of 128."""
    return -(-int(x) // 128) * 128
