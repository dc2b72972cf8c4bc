"""Mean ``upload.copy`` + ``upload.sync`` a scan: ``_upload``'s pad and
pageable copy to the card, and the wait for it (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "upload.copy", "upload.sync")
