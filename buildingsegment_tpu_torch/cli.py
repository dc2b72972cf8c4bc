"""Command-line interface of the port.

Port of ``buildingsegment_tpu/cli.py``: the reference's argv contract
(``tmc3 -a=<in.ply> -s=<out.ply>``, parsed by ``analyse_path`` at
tmc3/my_function.cpp:163-178, which splits each argument on '=' and
ignores the flag letter) plus the ``--flag`` extensions that expose the
reference's hard-coded constants.  The pipeline runs on the card.

Usage:
    python -m buildingsegment_tpu_torch.cli -a=scan.ply -s=labeled.ply
    python -m buildingsegment_tpu_torch.cli -a=scan.ply -s=out.ply \\
        --knn-method pallas --th-thickness 300 --profile --json-summary
    python -m buildingsegment_tpu_torch.cli -a=scan.ply -s=out.ply \\
        --render-dir renders --extract-contours
    python -m buildingsegment_tpu_torch.cli --batch IN_DIR OUT_DIR \\
        [--render-dir renders] [--json-summary] [--trace traces]
    python -m buildingsegment_tpu_torch.cli -a=scan.ply -s=out.ply \\
        --trace traces --dump-stages stages.npz
    python -m buildingsegment_tpu_torch.cli -a=small.ply -s=out.ply --golden

As in the JAX package, ``--batch`` runs before and without the other
single-scan flags, and ``--golden`` replaces the device pipeline.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys

from buildingsegment_tpu_torch.config import PipelineConfig

__all__ = ["main", "parse_args"]

def parse_args(argv):
    """Split reference-style ``-x=path`` args from ``--flag`` extensions.

    Returns (argparse namespace, input path or None, output path or None).
    """
    ref_style = {}
    rest = []
    for a in argv:
        if len(a) >= 2 and a[0] == "-" and a[1] != "-" and "=" in a:
            # reference semantics: split on '=', value is field [1]
            key = a.split("=")[0].lstrip("-")
            ref_style[key] = a.split("=", 1)[1]
        else:
            rest.append(a)

    p = argparse.ArgumentParser(
        prog="buildingsegment_tpu_torch",
        description="Building point-cloud plane segmentation on a CUDA card",
    )
    p.add_argument("--input", help="input PLY (alias of -a=)")
    p.add_argument("--output", help="output labeled PLY (alias of -s=)")
    p.add_argument("--position-scale", type=float, default=1000.0)
    p.add_argument("--knn-k", type=int, default=15)
    p.add_argument("--normal-radius", type=float, default=100.0)
    p.add_argument(
        "--knn-method",
        choices=["auto", "brute", "window", "pallas"],
        default="auto",
        help="auto: Morton-window above 65k points, exact brute below; "
        "pallas: exact kNN on the box-pruned kernel",
    )
    p.add_argument("--normal-max-nn", type=int, default=50)
    p.add_argument("--th-thickness", type=float, default=300.0)
    p.add_argument("--th-point-count", type=int, default=400)
    p.add_argument("--th-normal-cos", type=float, default=0.88)
    p.add_argument(
        "--golden",
        action="store_true",
        help="run the host oracle of the reference's sequential region "
        "growing (seg/golden.py) on the device's kNN and normals (small "
        "scans)",
    )
    p.add_argument(
        "--signed-normals",
        action="store_true",
        help="strict reference semantics (unstable on vertical walls)",
    )

    def _dedup_bits(s):
        v = int(s)
        if v < 0:
            raise argparse.ArgumentTypeError("--dedup-bits must be >= 0")
        return v

    p.add_argument(
        "--dedup-bits",
        type=_dedup_bits,
        default=None,
        metavar="N",
        help="remove duplicate points whose quantized positions match "
        "after dropping N low bits (first occurrence survives; the "
        "reference's removeDuplicatePointInQuantizedPoint, "
        "PCCPointSet.h:457-472); 0 = exact-duplicate removal",
    )
    p.add_argument("--ascii", action="store_true", help="write ascii PLY")
    p.add_argument(
        "--render-dir",
        help="also render the ortho height/density PNGs into DIR (the "
        "reference's disabled raster path, TMC3.cpp:223-226); with "
        "--batch, one subdirectory per scan",
    )
    p.add_argument("--profile", action="store_true", help="print stage timings")
    p.add_argument(
        "--extract-contours",
        action="store_true",
        help="with --render-dir: also extract building contours from the "
        "density render and extrude them to csa.obj (TMC3.cpp:223-226)",
    )
    p.add_argument(
        "--trace",
        metavar="DIR",
        help="write a torch.profiler trace of the run (host spans of every "
        "thread and the card's kernels) to DIR/trace.json (view in "
        "Perfetto); with --batch, of the whole batch",
    )
    p.add_argument(
        "--json-summary", action="store_true", help="print a JSON run summary"
    )
    p.add_argument(
        "--batch",
        nargs=2,
        metavar=("IN_DIR", "OUT_DIR"),
        help="multi-scan mode: segment every .ply in IN_DIR into OUT_DIR",
    )
    p.add_argument(
        "--dump-stages",
        metavar="NPZ",
        help="write stage outputs (labels, plane table) as .npz for "
        "debugging",
    )
    args = p.parse_args(rest)

    input_path = ref_style.get("a") or args.input
    output_path = ref_style.get("s") or args.output
    return args, input_path, output_path


def main(argv=None, *, device="cuda") -> int:
    """Run the CLI; ``device`` is where the pipeline runs (the card
    unless a caller, such as a test, asks for "cpu")."""
    argv = sys.argv[1:] if argv is None else argv
    args, input_path, output_path = parse_args(argv)
    if not args.batch and (not input_path or not output_path):
        print("usage: buildingsegment_tpu_torch -a=<in.ply> -s=<out.ply> "
              "[--flags]\n"
              "       buildingsegment_tpu_torch --batch IN_DIR OUT_DIR "
              "[--flags]", file=sys.stderr)
        return 2

    config = PipelineConfig(
        position_scale=args.position_scale,
        knn_method=args.knn_method,
        knn_k=args.knn_k,
        normal_radius=args.normal_radius,
        normal_max_nn=args.normal_max_nn,
        th_thickness=args.th_thickness,
        th_point_count=args.th_point_count,
        th_normal_cos=args.th_normal_cos,
        output_binary=not args.ascii,
        dedup_bits=args.dedup_bits,
    )

    from buildingsegment_tpu_torch.pipeline import (
        dump_stages,
        segment_file,
        segment_files,
    )

    trace_cm = contextlib.nullcontext()
    if args.trace:
        from buildingsegment_tpu_torch.profiling import trace

        trace_cm = trace(args.trace, device=device)

    if args.batch:
        in_dir, out_dir = args.batch
        inputs = sorted(glob.glob(os.path.join(in_dir, "*.ply")))
        if not inputs:
            print(f"error: no .ply files in {in_dir}", file=sys.stderr)
            return 1
        os.makedirs(out_dir, exist_ok=True)
        outs = [os.path.join(out_dir, os.path.basename(p)) for p in inputs]
        with trace_cm:
            results = segment_files(inputs, outs, config, device=device,
                                    signed_normals=args.signed_normals,
                                    render_dir=args.render_dir)
        total_pts = sum(r.cloud.count for r in results)
        rate = total_pts / max(sum(r.timings["total"] for r in results),
                               1e-9) / 1e6
        print(f"{len(results)} scans, {total_pts} points, "
              f"{sum(r.num_planes for r in results)} planes, "
              f"{rate:.3f} Mpoints/sec")
        if args.json_summary:
            print(json.dumps({
                "scans": len(results),
                "points": total_pts,
                "planes": [r.num_planes for r in results],
                "mpoints_per_sec": rate,
                "diagnostics": [r.diagnostics for r in results],
            }))
        return 0

    if args.golden:
        return _run_golden(input_path, output_path, config, device)

    try:
        with trace_cm:
            out = segment_file(input_path, output_path, config,
                               device=device,
                               signed_normals=args.signed_normals)
    except FileNotFoundError:
        print(f"error: cannot open {input_path}", file=sys.stderr)
        return 1

    if args.dump_stages:
        dump_stages(out, args.dump_stages, device=device)

    if args.render_dir:
        from buildingsegment_tpu_torch.raster.contours import (
            extracted_contour,
        )
        from buildingsegment_tpu_torch.raster.ortho import (
            DENSITY_PNG,
            render_ortho_views,
        )

        paths = render_ortho_views(out, args.render_dir, config)
        if args.extract_contours:
            extracted_contour(
                paths[DENSITY_PNG],
                os.path.join(args.render_dir, "extracted_contours.png"),
                os.path.join(args.render_dir, "extracted_contours_flip.png"),
                obj_path=os.path.join(args.render_dir, "csa.obj"),
                threshold=config.contour_threshold,
                min_area=config.contour_min_area,
                min_perimeter=config.contour_min_perimeter,
                close_iterations=config.contour_close_iters,
            )

    print(f"{out.cloud.count} points → {out.num_planes} planes → {output_path}")
    if args.profile:
        for stage, secs in out.timings.items():
            print(f"  {stage:>20}: {secs:.4f}")
    if args.json_summary:
        print(json.dumps({
            "points": out.cloud.count,
            "planes": out.num_planes,
            "plane_counts": out.plane_counts.tolist(),
            "timings": out.timings,
            "diagnostics": out.diagnostics,
        }))
    return 0


def _run_golden(input_path, output_path, config, device) -> int:
    """The reference's semantics end to end on the host oracle: exact kNN
    and normals on ``device``, then ``golden_segment`` (sequential region
    growing with every quirk) and the MSVC ``rand()`` colors.  O(n·k)
    Python: small scans."""
    import numpy as np
    import torch

    from buildingsegment_tpu_torch.core.pointset import PointBatch
    from buildingsegment_tpu_torch.io.ply import (
        HostPointCloud, read_ply, write_ply,
    )
    from buildingsegment_tpu_torch.ops.knn import knn
    from buildingsegment_tpu_torch.ops.normals import estimate_normals
    from buildingsegment_tpu_torch.seg.colorize import msvc_rand_colors
    from buildingsegment_tpu_torch.seg.golden import golden_segment

    try:
        cloud = read_ply(input_path, position_scale=config.position_scale)
    except FileNotFoundError:
        print(f"error: cannot open {input_path}", file=sys.stderr)
        return 1
    pts = cloud.positions - cloud.positions.min(axis=0)
    n = len(pts)
    batch = PointBatch.upload(pts, config.padded_count(n),
                              device=torch.device(device))
    k_search = max(config.knn_k, config.normal_max_nn)
    idx, d = knn(batch.positions, batch.mask, k=k_search)
    normals, _ = estimate_normals(
        batch.positions, batch.mask, idx, d,
        radius=config.normal_radius, max_nn=config.normal_max_nn,
    )
    _plane_idx, planes = golden_segment(
        pts,
        normals[:n].cpu().numpy().astype(np.float64),
        idx[:n, : config.knn_k].cpu().numpy(),
        k=config.knn_k,
        th_thickness=config.th_thickness,
        th_point_count=config.th_point_count,
        th_normal_cos=config.th_normal_cos,
    )
    colors = np.zeros((n, 3), np.uint16)
    table = msvc_rand_colors(len(planes), config.color_low,
                             config.color_range)
    for p, col in zip(planes, table):
        colors[np.asarray(p.point_idx)] = col
    write_ply(
        HostPointCloud(positions=pts.astype(np.int32), colors=colors),
        output_path,
        position_scale=config.output_scale,
        ascii=not config.output_binary,
    )
    print(f"{n} points → {len(planes)} planes (golden oracle) → "
          f"{output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
