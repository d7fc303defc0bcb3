"""Find a serving cell's knee: the cell's traffic at several loads, one
short run each, in one process on the card:

    python3 bench_port/sweep.py --workload <name> --key rate_per_s --loads 400,800,... --seconds 8

(``--config`` and ``--traffic`` name the files of a cell that
``BENCHMARK.json`` does not list yet.)

Prints, for each load, the end-to-end tail, the completed and offered
counts, and the trend of the latency over the window (the median of its
last quarter over that of its first): a backlog that grows shows as a
trend well above 1.  Each load's comparison with the reference is
printed with its numbers (``checks``), so that a load whose answers are
not correct shows why.  The knee is the highest load with no growing
backlog; the cell's load is set at about four fifths of it.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import common  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--key", required=True, help="the mix parameter swept")
    ap.add_argument("--loads", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--config", help="with --traffic: a cell that BENCHMARK.json does not list yet")
    ap.add_argument("--traffic")
    args = ap.parse_args(argv)
    common.setup_cache_env()
    import torch

    from bench_port.run import Ctx, run_cell

    if not torch.cuda.is_available():
        print("bench_port sweep: needs a CUDA card", file=sys.stderr)
        return 2
    for load in args.loads.split(","):
        entry = ({"config": args.config, "traffic": args.traffic, "chips": 1}
                 if args.config else None)
        cell = common.cell(args.workload, entry)
        cell["mix"][args.key] = float(load) if "." in load else int(load)
        run = run_cell(Ctx(cell, args.seed, args.seconds, False, torch.device("cuda", 0)))
        lat = run.values.get("latency_s") or run.values.get("chunk_latency_s")
        q = max(1, len(lat) // 4)
        finite = [x for x in lat if x != float("inf")]
        late = sorted(run.lateness) or [0.0]
        print(json.dumps({
            args.key: load, "attempted": run.attempted, "failed": run.failed,
            "p50_ms": statistics.median(lat) * 1e3, "p95_ms": common.percentile(lat, 95) * 1e3,
            "max_ms": max(finite) * 1e3 if finite else None,
            "trend": statistics.median(lat[-q:]) / max(statistics.median(lat[:q]), 1e-9),
            "lateness_p99_ms": common.percentile(late, 99) * 1e3,
            "correct": run.correct, "checks": run.checks, "counters": run.counters,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
