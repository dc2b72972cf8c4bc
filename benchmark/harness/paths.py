"""The module of the kNN path a configuration states.

A configuration's top-level ``knn_method`` names the path every pool
scan takes (``traffic/cli_loop.check_paths`` holds them to it).  Stage 1
differs by path: the port's function that makes it, the plain reference
that works it out again, and the numbers that compare the two.  So each
path has a file of its own, ``benchmark/paths/<knn_method>.py``, with:

* ``capture(into)``: a context manager that appends stage 1's outputs,
  as the timed path made them, to ``into``, one a scan run inside it;
* ``reference(mm, params, *, capacity, device, tf32=False) -> RefScan``:
  the plain reference of one scan (``tf32=True`` is the control);
* ``compare_stage1(got, ref_stage1, n) -> {name: number}``: stage 1's
  numbers over the ``n`` input points.

A configuration on a path the benchmark has not run yet enters by a new
file there, beside its configuration and workload files.
"""

from __future__ import annotations

import os

from benchmark.harness.manifest import bench_dir, load_file


def load_path(cell):
    """The module of the path the cell's configuration states, importable
    by the name ``benchmark.paths.<knn_method>``.  A configuration that
    states no path, or one with no file, stops the run (in set-up, before
    the pool is made)."""
    method = cell.config.get("knn_method")
    path = os.path.join(bench_dir(cell.root), "paths",
                        f"{method or '<knn_method>'}.py")
    if method is None:
        raise SystemExit(f"configuration {cell.config['name']!r} states no "
                         f"knn_method: stage 1 is compared by {path}")
    if not os.path.isfile(path):
        raise SystemExit(f"configuration {cell.config['name']!r} states "
                         f"knn_method {method!r}: no file {path}")
    return load_file(path, f"benchmark.paths.{method}")
