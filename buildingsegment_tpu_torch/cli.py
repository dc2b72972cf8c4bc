"""Command-line interface of the port.

Port of ``buildingsegment_tpu/cli.py``: the reference's argv contract
(``tmc3 -a=<in.ply> -s=<out.ply>``, parsed by ``analyse_path`` at
tmc3/my_function.cpp:163-178, which splits each argument on '=' and
ignores the flag letter) plus the ``--flag`` extensions that expose the
reference's hard-coded constants.  ``segment_file`` runs on the card.

Usage:
    python -m buildingsegment_tpu_torch.cli -a=scan.ply -s=labeled.ply
    python -m buildingsegment_tpu_torch.cli -a=scan.ply -s=out.ply \\
        --knn-method pallas --th-thickness 300 --profile --json-summary

The flags of paths the port does not have yet (the render, contours,
multi-scan, the golden oracle, tracing, stage dumps) are accepted by
the parser and exit with code 2 naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json
import sys

from buildingsegment_tpu_torch.config import PipelineConfig

__all__ = ["main", "parse_args"]

#: flag → the ROADMAP.md item (Queue B, "Next slices") that ports it
_NOT_PORTED = {
    "render_dir": "--render-dir: 'Raster (raster/ortho.py, ops/scatter.py) "
                  "with #8'",
    "extract_contours": "--extract-contours: 'Raster (raster/ortho.py, "
                        "ops/scatter.py) with #8'",
    "batch": "--batch: 'Bench and profiling' (segment_files multi-scan)",
    "dump_stages": "--dump-stages: 'Bench and profiling' (dump_stages)",
    "trace": "--trace: 'Bench and profiling' (a torch.profiler trace)",
    "golden": "--golden: the golden oracle (seg/golden.py), not in any "
              "slice yet",
}


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
    p.add_argument("--golden", action="store_true",
                   help="host oracle of the reference (not ported)")
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
    p.add_argument("--render-dir", help="ortho renders (not ported)")
    p.add_argument("--profile", action="store_true", help="print stage timings")
    p.add_argument("--extract-contours", action="store_true",
                   help="contour extraction (not ported)")
    p.add_argument("--trace", metavar="DIR", help="device trace (not ported)")
    p.add_argument(
        "--json-summary", action="store_true", help="print a JSON run summary"
    )
    p.add_argument("--batch", nargs=2, metavar=("IN_DIR", "OUT_DIR"),
                   help="multi-scan mode (not ported)")
    p.add_argument("--dump-stages", metavar="NPZ",
                   help="stage outputs as .npz (not ported)")
    args = p.parse_args(rest)

    input_path = ref_style.get("a") or args.input
    output_path = ref_style.get("s") or args.output
    return args, input_path, output_path


def main(argv=None, *, device="cuda") -> int:
    """Run the CLI; ``device`` is where the pipeline runs (the card
    unless a caller, such as a test, asks for "cpu")."""
    argv = sys.argv[1:] if argv is None else argv
    args, input_path, output_path = parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            print(f"error: {item} is a later slice of the port "
                  "(ROADMAP.md)", file=sys.stderr)
            return 2
    if not input_path or not output_path:
        print("usage: buildingsegment_tpu_torch -a=<in.ply> -s=<out.ply> "
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

    from buildingsegment_tpu_torch.pipeline import segment_file

    try:
        out = segment_file(input_path, output_path, config, device=device,
                           signed_normals=args.signed_normals)
    except FileNotFoundError:
        print(f"error: cannot open {input_path}", file=sys.stderr)
        return 1

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


if __name__ == "__main__":
    sys.exit(main())
