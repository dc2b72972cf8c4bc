"""What the metric readers share: the rows of the scans completed in the
window and the means of the port's own per-scan timings and counters."""

from __future__ import annotations

from typing import Optional

from benchmark.harness.arith import mean


def rows(record: dict) -> list:
    return record.get("window", {}).get("rows", [])


def timing_ms(record: dict, *keys: str) -> Optional[float]:
    """Mean over the window's scans of the sum of ``PipelineOutput.timings``
    entries ``keys``, in ms; None where a scan lacks one."""
    vals = []
    for r in rows(record):
        t = r.get("timings", {})
        if not all(k in t for k in keys):
            return None
        vals.append(1e3 * sum(t[k] for k in keys))
    return mean(vals)


def counter(record: dict, get) -> Optional[float]:
    """Mean over the window's scans of ``get(row)`` (None rows left out)."""
    return mean(v for v in (get(r) for r in rows(record)) if v is not None)


def roofline_pct(record: dict, kernel: str) -> Optional[float]:
    """100 × Σ least seconds / Σ device seconds over the traced calls of
    ``kernel`` (None without calls, or when the traced and the counted
    runs saw different numbers of calls)."""
    from benchmark.roofline.peaks import least_seconds

    times = record.get("profile", {}).get("kernel_device_s", {}).get(kernel)
    work = record.get("kernel_work", {}).get(kernel)
    if not times or not work or len(times) != len(work):
        return None
    device = sum(times)
    if device <= 0:
        return None
    return 100.0 * sum(least_seconds(b, o) for b, o in work) / device
