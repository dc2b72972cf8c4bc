"""Batches back to back, one client: ``pipeline.segment_files(inputs,
outputs, render_dir=R)`` over batches of the configuration's pool, as a
survey crew's ``--batch`` run (BASELINE config 5).  The labeled PLYs go
to ``os.devnull`` through the port's writer; the three PNGs of each scan
are written under the run's TMPDIR, overwritten each time the scan comes
round.  After the window the sampled scans' outputs are written to real
files and read back, and their PNGs are read as the window left them.

Parameters: ``batch`` (scans a call), ``sample_scans``, ``traced_batches``.
"""

from __future__ import annotations

import os
import time

from benchmark.harness import loop
from benchmark.harness.check import ScanOut
from benchmark.harness.paths import load_path
from benchmark.harness.refcheck import (
    bucket_capacity,
    file_numbers,
    read_rasters,
    read_written_ply,
)
from benchmark.harness.scenes import make_pool
from benchmark.harness.trace import profile_block
from benchmark.harness.wraps import kernel_spans, kernel_work, roofline_kernels
from benchmark.traffic.cli_loop import check_paths


def run(cell, ctx: loop.Ctx) -> dict:
    knn_path = load_path(cell)
    from buildingsegment_tpu_torch import pipeline
    from buildingsegment_tpu_torch.config import PipelineConfig
    from buildingsegment_tpu_torch.io.ply import write_ply

    config = PipelineConfig(**cell.config["pipeline"])
    mult = config.pad_to_multiple
    scans = make_pool(cell.config["scene"], ctx.seed)
    paths = loop.write_pool(scans, ctx.tmpdir)
    loop.note(ctx, f"pool made and written: {[len(s) for s in scans]} points")
    check_paths(cell, pipeline, config, scans,
                lambda n: bucket_capacity(n, mult))
    loop.build_port(ctx.device)
    size = cell.params()["batch"]
    n_batches = -(-len(scans) // size)
    picked = loop.sample(len(scans), cell.params()["sample_scans"], ctx.seed)
    render_dir = os.path.join(ctx.tmpdir, "render")

    def members(b):
        return [(b * size + q) % len(scans) for q in range(size)]

    def batch(b):
        js = members(b)
        outs = pipeline.segment_files(
            [paths[j] for j in js], [os.devnull] * len(js), config,
            device=ctx.device, render_dir=render_dir)
        if len(outs) != len(js):
            raise RuntimeError(f"{len(js)} scans in, {len(outs)} out")
        return js, outs

    # warm-up: every batch once; stage 1 of each scan as the timed path
    # made it
    stage1 = {}
    for b in range(n_batches):
        cap = []
        with knn_path.capture(cap):
            js, _outs = batch(b)
        for j, s1 in zip(js, cap):
            if j in picked:
                stage1[j] = s1
    loop.note(ctx, "warm-up done")
    peak_setup = loop.memory_peak(ctx.device)
    loop.reset_peak(ctx.device)

    kept = {}

    def step(i):
        js, outs = batch(i % n_batches)
        for j, out in zip(js, outs):
            if j in picked:
                kept[j] = out
        return {"scans": [{"pool": j, "points": len(scans[j]),
                           "timings": dict(out.timings),
                           "host_syncs": out.host_syncs,
                           "num_sweeps": out.num_sweeps}
                          for j, out in zip(js, outs)]}

    t0 = time.perf_counter()
    window = loop.closed_loop(step, n_batches, ctx.seconds, t0)
    peak_window = loop.memory_peak(ctx.device)
    # one row a scan, each ending with its batch
    scans_rows = [dict(s, start=r["start"], end=r["end"],
                       latency_s=r["latency_s"])
                  for r in window["rows"] for s in r["scans"]]
    record = {
        "setup_s": t0 - ctx.t_start,
        "window": dict(window, rows=scans_rows,
                       attempted=window["attempted"] * size,
                       failed=window["failed"] * size),
        "peak_bytes": {"setup": peak_setup, "window": peak_window},
    }
    if ctx.trace:
        kernels = roofline_kernels(cell)
        traced = [(window["next"] + q) % n_batches
                  for q in range(cell.params()["traced_batches"])]

        def traced_batches():
            for b in traced:
                batch(b)
        with kernel_spans(kernels):
            record["profile"] = profile_block(traced_batches, ctx.device,
                                              ctx.tmpdir)
        record["kernel_work"] = {}
        with kernel_work(kernels, record["kernel_work"]):
            traced_batches()

    got = {}
    for j in picked:
        out = got[j] = kept.pop(j, None)
        if out is None:  # the window never finished it: it fails
            continue
        path = os.path.join(ctx.tmpdir, f"out{j}.ply")
        write_ply(out.cloud, path, position_scale=config.output_scale,
                  position_offset=(0.0, 0.0, 0.0),
                  ascii=not config.output_binary)
        base = os.path.splitext(os.path.basename(paths[j]))[0]
        got[j] = ScanOut(
            labels=out.plane_idx, num_planes=out.num_planes,
            plane_normals=out.plane_normals, plane_centers=out.plane_centers,
            plane_counts=out.plane_counts, stage1=stage1[j],
            ply=read_written_ply(path),
            rasters=read_rasters(os.path.join(render_dir, base)))
        os.remove(path)
    record["compare"] = {"got": got, "inputs": paths}
    return record


def check(cell, record: dict, ctx: loop.Ctx, control: bool = False) -> dict:
    mult = cell.config["pipeline"]["pad_to_multiple"]
    cmp = record["compare"]
    return file_numbers(
        cell, cmp["got"], dict(enumerate(cmp["inputs"])),
        lambda n: bucket_capacity(n, mult), ctx.device, rasters=True,
        control=control)
