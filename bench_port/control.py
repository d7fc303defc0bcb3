"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process:

    python3 bench_port/control.py --workload <name> --seeds 101,102,... --seconds 3

For each seed, one short run of the cell (its traffic, its timed path, its
sample of answers) reads the numbers its check compares twice: for the
program's answers (the lower reading), and for the plain reference put in
the program's place in the precision just below the configuration's
(``"control"`` of the configuration file: float32 for the 'double' tier,
TF32 for float32), which the limits have to fail (the upper reading).
Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.
"""

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import check, common  # noqa: E402


def readings(workload, seeds, seconds, device):
    """``[(seed, program numbers, control numbers)]``."""
    from bench_port.run import Ctx, run_cell

    cell = common.cell(workload)
    control = cell["config"]["control"]
    compare = check.compare
    out = []

    def both(spec, items, dev, precision="float64"):
        got = compare(spec, items, dev, precision)
        ctrl = [(sig, spec.features(sig, dev, control), upto) for sig, _, upto in items]
        out.append((got, compare(spec, ctrl, dev, precision)))
        return got

    check.compare = both
    try:
        rows = []
        for seed in seeds:
            run_cell(Ctx(cell, seed, seconds, False, device))
            rows.append((seed, *out[-1]))
        return rows
    finally:
        check.compare = compare


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    common.setup_cache_env()
    import torch

    if not torch.cuda.is_available():
        print("bench_port control: needs a CUDA card", file=sys.stderr)
        return 2
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
                    torch.device("cuda", 0))
    for seed, prog, ctrl in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl}), flush=True)
    names = rows[0][1].keys()
    print(json.dumps({
        "workload": args.workload,
        "program_max": {k: max(r[1][k] for r in rows) for k in names},
        "control_min": {k: min(r[2][k] for r in rows) for k in names},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
