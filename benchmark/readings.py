"""The readings a cell's limits are set from (not run by the benchmark's
own runs).

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2] [--out chiprun_out/x.jsonl]

For each of ``--seeds``: one run of the cell's traffic through its timed
entry (a short window at the cell's own sizes), then the comparison with
the plain reference: the program's numbers.  For each of
``--control-seeds``: the same run, with the control (the reference
computed with TF32 products) in the program's place.  One JSON line a
reading; the last line gives each number's largest program reading and
smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import tempfile

    import torch

    from benchmark.harness import loop
    from benchmark.harness.manifest import load_cell, load_traffic

    if args.device is None and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device(args.device or "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(args.workload, args.root)
    traffic = load_traffic(cell)
    lines = []
    jobs = ([(s, False) for s in args.seeds]
            + [(s, True) for s in args.control_seeds])
    for seed, control in jobs:
        with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
            t0 = time.perf_counter()
            ctx = loop.Ctx(seed=seed, seconds=args.seconds, trace=False,
                           device=device, tmpdir=tmp, t_start=t0,
                           t_start_wall=time.time())
            record = traffic.run(cell, ctx)
            t1 = time.perf_counter()
            numbers = traffic.check(cell, record, ctx, control=control)
            line = {"workload": cell.name, "seed": seed,
                    "control": control, "numbers": numbers,
                    "run_s": t1 - t0,
                    "reference_s": time.perf_counter() - t1}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": cell.name, "program_max": {}, "control_min": {}}
    for line in lines:
        key = "control_min" if line["control"] else "program_max"
        pick = min if line["control"] else max
        for k, v in line["numbers"].items():
            have = summary[key].get(k)
            summary[key][k] = v if have is None else pick(have, v)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
