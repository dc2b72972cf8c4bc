"""What the traffic kinds share: the run's context, the pool on disk, the
closed loop over a window, the sample of scans the comparison reads,
and the device's memory peak."""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import traceback
from typing import Callable, List

import numpy as np
import torch

from benchmark.reference.io import write_input_ply


@dataclasses.dataclass
class Ctx:
    """One run: its arguments, the device, a scratch directory under the
    run's TMPDIR, and the process's start on the host clock."""

    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmpdir: str
    t_start: float               # time.perf_counter() at process start
    t_start_wall: float          # time.time() at the same moment


def note(ctx: "Ctx", msg: str) -> None:
    """A line on standard error with the seconds since the process
    started."""
    print(f"[{time.perf_counter() - ctx.t_start:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def build_port(device: torch.device) -> None:
    """Load the port's kernels from its fixed ``_build/`` cache (built
    there on the checkout's first run)."""
    if device.type == "cuda":
        from buildingsegment_tpu_torch import kernels

        kernels.build()


def write_pool(scans: List[np.ndarray], tmpdir: str) -> List[str]:
    """The pool's input PLYs under ``tmpdir``, one a scan."""
    paths = []
    for i, mm in enumerate(scans):
        path = os.path.join(tmpdir, f"scan{i}.ply")
        write_input_ply(path, mm)
        paths.append(path)
    return paths


def sample(n_pool: int, k: int, seed: int) -> List[int]:
    """The pool scans the comparison reads: the largest (the last of the
    pool) and ``k`` − 1 others drawn from the seed."""
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    others = rng.choice(n_pool - 1, size=min(k - 1, n_pool - 1),
                        replace=False)
    return sorted({n_pool - 1, *(int(i) for i in others)})


def closed_loop(step: Callable[[int], dict], n_pool: int, seconds: float,
                t0: float) -> dict:
    """One client, one request at a time: ``step(i)`` for i = 0, 1, ...
    (the caller maps i onto its pool) until ``seconds`` after ``t0``
    have passed; the request in flight then completes.  Each row is
    ``step``'s dict with ``start``, ``end`` and ``latency_s`` added."""
    rows, failed, i = [], 0, 0
    while True:
        start = time.perf_counter()
        if start - t0 >= seconds:
            break
        try:
            row = step(i)
        except Exception:  # counted; the run then reads not correct
            traceback.print_exc(file=sys.stderr)
            failed += 1
            row = None
        end = time.perf_counter()
        if row is not None:
            rows.append(dict(row, start=start, end=end,
                             latency_s=end - start))
        i += 1
    return {"rows": rows, "attempted": i, "failed": failed, "start": t0,
            "next": i}


def memory_peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
