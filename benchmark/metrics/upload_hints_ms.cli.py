"""Mean ``upload.hints`` a scan: ``_upload``'s proven hints on the host,
``morton_small`` and the spacing hint's voxel count (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "upload.hints")
