"""Closed loop, one client: ``pipeline.segment_file(src, dst)`` over the
configuration's pool of input PLYs, cycled in order, as a user runs the
CLI scan after scan.  Each labeled PLY is encoded and written by the
port's own writer to ``os.devnull`` (the page-cache copy, ~27 bytes a
point, is left out); after the window, the sampled scans' outputs are
written to real files and read back for the comparison.

Parameters (the workload file's ``params``): ``sample_scans``, how many
pool scans the comparison reads; ``traced_scans``, how many whole scans
the ``--trace 1`` run profiles after the window.
"""

from __future__ import annotations

import contextlib
import os
import time

from benchmark.harness import loop
from benchmark.harness.check import ScanOut
from benchmark.harness.paths import load_path
from benchmark.harness.refcheck import (
    file_numbers,
    padded_count,
    read_written_ply,
)
from benchmark.harness.scenes import make_pool
from benchmark.harness.trace import profile_block
from benchmark.harness.wraps import kernel_spans, kernel_work, roofline_kernels


def _port(cell):
    from buildingsegment_tpu_torch import pipeline
    from buildingsegment_tpu_torch.config import PipelineConfig

    return pipeline, PipelineConfig(**cell.config["pipeline"])


def check_paths(cell, pipeline, config, scans, capacity) -> None:
    """Every scan takes the path the configuration names."""
    want = cell.config["knn_method"]
    for i, mm in enumerate(scans):
        got = pipeline.resolve_knn_method(config, capacity(len(mm)))
        if got != want:
            raise SystemExit(f"pool scan {i} ({len(mm)} points) resolves to "
                             f"{got!r}, the configuration states {want!r}")


def run(cell, ctx: loop.Ctx) -> dict:
    knn_path = load_path(cell)
    pipeline, config = _port(cell)
    from buildingsegment_tpu_torch.io.ply import write_ply

    scans = make_pool(cell.config["scene"], ctx.seed)
    paths = loop.write_pool(scans, ctx.tmpdir)
    loop.note(ctx, f"pool made and written: {[len(s) for s in scans]} points")
    check_paths(cell, pipeline, config, scans, config.padded_count)
    loop.build_port(ctx.device)
    picked = loop.sample(len(scans), cell.params()["sample_scans"], ctx.seed)

    def segment(j):
        return pipeline.segment_file(paths[j], os.devnull, config,
                                     device=ctx.device)

    # warm-up: every scan of the pool once, the largest first; stage 1 of
    # the sampled scans is kept as this, the timed path, made it
    stage1 = {}
    for j in reversed(range(len(scans))):
        cap = [] if j in picked else None
        with (contextlib.nullcontext() if cap is None
              else knn_path.capture(cap)):
            segment(j)
        if cap:
            stage1[j] = cap[0]
    loop.note(ctx, "warm-up done")
    peak_setup = loop.memory_peak(ctx.device)
    loop.reset_peak(ctx.device)

    kept = {}

    def step(i):
        j = i % len(scans)
        out = segment(j)
        if j in picked:
            kept[j] = out
        out.device_shifted = out.device_mask = None
        return {"pool": j, "points": len(scans[j]),
                "timings": dict(out.timings), "host_syncs": out.host_syncs,
                "num_sweeps": out.num_sweeps}

    t0 = time.perf_counter()
    window = loop.closed_loop(step, len(scans), ctx.seconds, t0)
    peak_window = loop.memory_peak(ctx.device)
    record = {
        "setup_s": t0 - ctx.t_start,
        "window": window,
        "peak_bytes": {"setup": peak_setup, "window": peak_window},
    }
    if ctx.trace:
        kernels = roofline_kernels(cell)
        traced = [(window["next"] + q) % len(scans)
                  for q in range(cell.params()["traced_scans"])]

        def traced_scans():
            for j in traced:
                segment(j)
        with kernel_spans(kernels):
            record["profile"] = profile_block(traced_scans, ctx.device,
                                              ctx.tmpdir)
        record["kernel_work"] = {}
        with kernel_work(kernels, record["kernel_work"]):
            traced_scans()

    # the sampled scans' outputs, written by the port's writer and read
    # back (a scan the window never finished has none, and fails)
    got = {}
    for j in picked:
        out = got[j] = kept.pop(j, None)
        if out is None:
            continue
        path = os.path.join(ctx.tmpdir, f"out{j}.ply")
        write_ply(out.cloud, path, position_scale=config.output_scale,
                  position_offset=(0.0, 0.0, 0.0),
                  ascii=not config.output_binary)
        got[j] = ScanOut(
            labels=out.plane_idx, num_planes=out.num_planes,
            plane_normals=out.plane_normals, plane_centers=out.plane_centers,
            plane_counts=out.plane_counts, stage1=stage1[j],
            ply=read_written_ply(path))
        os.remove(path)
    record["compare"] = {"got": got, "inputs": paths}
    return record


def check(cell, record: dict, ctx: loop.Ctx, control: bool = False) -> dict:
    """The numbers of the comparison (run once the window has closed and
    the port's device state is freed)."""
    mult = cell.config["pipeline"]["pad_to_multiple"]
    cmp = record["compare"]
    return file_numbers(
        cell, cmp["got"], dict(enumerate(cmp["inputs"])),
        lambda n: padded_count(n, mult), ctx.device, control=control)
