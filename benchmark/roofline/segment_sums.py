"""Row S, the fixed-order segment sums (``csrc/segment_sum.cu``, its
order by ``csrc/segment_sort.cu``).  Bytes: the ids and the rows (and
``init``, where given) read once and the table written once.
Operations: one float32 addition a row and column."""

from benchmark.roofline.common import nbytes

ENTRY = "segment_sums_cuda"


def work(args, kw, out):
    rows = args[1]
    init = args[3] if len(args) > 3 else kw.get("init")
    return nbytes([args[0], rows, init, out]), rows.numel()
