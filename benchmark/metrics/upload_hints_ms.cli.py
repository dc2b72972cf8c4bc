"""Mean ``upload.hints`` a scan: ``_upload``'s proof of ``morton_small``
on the host (ms).  The spacing hint's occupied cells are counted in
stage 1 on the window path, not here."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "upload.hints")
