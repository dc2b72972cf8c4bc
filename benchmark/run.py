"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the port, ``buildingsegment_tpu_torch``.  The cell's traffic
(``benchmark/traffic/<kind>.py``) makes its inputs from the seed, loads
the port's kernels, warms up on the cell's own scans, drives the port
for ``--seconds`` and keeps what it needs for the comparison.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the traffic then traces a few whole
scans after the window).  Then the plain reference
(``benchmark/reference/``) runs on sampled scans and every number
compared is printed beside its limit, as the last lines of standard
error and under ``checks``, the last key of the result line.

Exits 2 without a card (or with fewer than the cell asks for), 3 where
the port is missing, 4 where JAX or the JAX package was loaded; each
prints no result.
"""

import time

T_START = time.perf_counter()
T_START_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """Name and power limit of each card, from ``nvidia-smi``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _forbidden_exit(where: str):
    from benchmark.harness.check import forbidden_modules

    found = forbidden_modules()
    if found:
        _say(f"{where}: modules of JAX or the JAX package are loaded: "
             f"{', '.join(found)}")
        sys.exit(4)


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, *, device=None, root=ROOT) -> dict:
    """One run of a cell → the result (a dict).  ``device`` None is the
    card, which must be there; tests pass "cpu" to drive the rest of a
    run on the port's plain paths."""
    import torch

    from benchmark.harness import loop
    from benchmark.harness.check import judge
    from benchmark.harness.manifest import load_cell, load_traffic, read_metrics
    from benchmark.harness.wraps import cache_dirs

    cell = load_cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            _say("no CUDA card: this benchmark measures the card only")
            sys.exit(2)
        if torch.cuda.device_count() < cell.chips:
            _say(f"{args.workload} needs {cell.chips} cards, "
                 f"{torch.cuda.device_count()} visible")
            sys.exit(2)
        device = "cuda:0"
        _say(f"cards: {card_line()} (count {torch.cuda.device_count()})")
    for key, path in cache_dirs(root).items():
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
    # the reference and every geometric step stay in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmpdir = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = loop.Ctx(seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device=torch.device(device),
                       tmpdir=tmpdir, t_start=T_START,
                       t_start_wall=T_START_WALL)
        traffic = load_traffic(cell)
        record = traffic.run(cell, ctx)
        _forbidden_exit("after the window")
        metrics = read_metrics(cell.per_layer if args.trace
                               else cell.end_to_end, record, root)
        dev = torch.device(device)
        peak = max(record["peak_bytes"].values())
        info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": peak}
        result = {"correct": False, "attempted": record["window"]["attempted"],
                  "failed": record["window"]["failed"], "metrics": metrics,
                  "device": info}
        if args.trace and record.get("profile"):
            prof = record["profile"]
            info["busy_s"] = prof["busy_s"]
            info["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
            for k, calls in record.get("kernel_work", {}).items():
                times = prof["kernel_device_s"].get(k, [])
                _say(f"kernel {k}: {len(times)} traced calls, "
                     f"{sum(times)!r} s; {len(calls)} counted")
        loop.note(ctx, "window closed; the reference runs")
        numbers = traffic.check(cell, record, ctx)
        loop.note(ctx, "reference done")
        ok, checks = judge(numbers, cell.limits())
        result["correct"] = bool(ok and result["failed"] == 0
                                 and result["attempted"] > 0)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def main(argv=None) -> int:
    args = parse(argv)
    if not os.path.exists(os.path.join(ROOT, "buildingsegment_tpu_torch",
                                       "__init__.py")):
        _say("the port (buildingsegment_tpu_torch) is not in this checkout")
        return 3
    result = run_cell(args)
    _forbidden_exit("at the end")
    for name, c in result["checks"].items():
        _say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
