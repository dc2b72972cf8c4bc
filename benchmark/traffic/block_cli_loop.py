"""Closed loop, one client, over a block configuration's pool: as
``cli_loop`` (``pipeline.segment_file(src, os.devnull)`` scan after scan,
cycled in order; the sampled scans' outputs written and read back for
the comparison after the window), with the pool made by
``harness/blocks.make_block_pool`` and each row carrying the scan's
``PipelineOutput.diagnostics`` beside its timings, ``host_syncs`` and
``num_sweeps``.

Parameters (the workload file's ``params``): ``sample_scans``, how many
pool scans the comparison reads; ``traced_scans``, how many whole scans
the ``--trace 1`` run profiles after the window.
"""

from __future__ import annotations

import contextlib
import os
import time

from benchmark.harness import loop
from benchmark.harness.blocks import make_block_pool
from benchmark.harness.check import ScanOut
from benchmark.harness.paths import load_path
from benchmark.harness.refcheck import read_written_ply
from benchmark.harness.trace import profile_block
from benchmark.harness.wraps import kernel_spans, kernel_work, roofline_kernels
from benchmark.traffic.cli_loop import _port, check, check_paths

__all__ = ["run", "check"]


def run(cell, ctx: loop.Ctx) -> dict:
    # a copy of cli_loop.run but for two lines: the pool comes from
    # make_block_pool (not scenes.make_pool), and each row adds
    # "diagnostics"; keep the rest in step with cli_loop.run
    knn_path = load_path(cell)
    pipeline, config = _port(cell)
    from buildingsegment_tpu_torch.io.ply import write_ply

    scans = make_block_pool(cell.config["scene"], ctx.seed)
    paths = loop.write_pool(scans, ctx.tmpdir)
    loop.note(ctx, f"pool made and written: {[len(s) for s in scans]} points")
    check_paths(cell, pipeline, config, scans, config.padded_count)
    loop.build_port(ctx.device)
    picked = loop.sample(len(scans), cell.params()["sample_scans"], ctx.seed)

    def segment(j):
        return pipeline.segment_file(paths[j], os.devnull, config,
                                     device=ctx.device)

    # warm-up: every scan of the pool once, the last first; stage 1 of
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
                "num_sweeps": out.num_sweeps,
                "diagnostics": dict(out.diagnostics)}

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
