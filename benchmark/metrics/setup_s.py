"""Process start to the first timed scan: imports, the kernels' load
(their build on a checkout's first run), the pool made and written, the
warm-up scans (s)."""


def read(record):
    return record.get("setup_s")
