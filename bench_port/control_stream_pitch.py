"""The readings the stream pitch cell's limits are set from, on the card at
the cell's own size, in one process:

    python3 bench_port/control_stream_pitch.py --workload fbank40-pitch-kaldi-online.stream-replay --seeds 101,102 --seconds 5

For each seed, one short run of the cell (``kinds/stream_replay.py``: its
traffic, its timed path, its sample of sessions) reads the numbers its
check compares, for the program's rows and for two controls put in their
place: the plain references at ``"tf32"`` (the filter bank on TF32
operands and the online pitch reference's NCCF products on TF32 operands)
and the online pitch reference at ``"viterbi32"`` (a float32 tracker with
no per-step cost shift).  The limits have to pass the program's readings
and fail each control's.  Prints one JSON line a seed, then the largest
program reading and each control's smallest reading of each number.
"""

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import check, common  # noqa: E402

CONTROLS = ("tf32", "viterbi32")


def readings(workload, seeds, seconds, device):
    """``[(seed, {"program": numbers, "tf32": numbers, "viterbi32": numbers})]``."""
    from bench_port.kinds import stream_replay
    from bench_port.kinds.corpus_pitch import numbers
    from bench_port.run import Ctx

    cell = common.cell(workload)
    control = cell["config"]["control"]
    taken = []

    def read(spec, pspec, fbank, pitch, dev):
        got = stream_replay.readings(spec, pspec, fbank, pitch, dev)
        ctrl = [(sig, spec.features(sig, dev, control), upto) for sig, _, upto in fbank]
        out = {"program": got, "tf32": check.compare(spec, ctrl, dev), "viterbi32": {}}
        for name in CONTROLS:
            ctrl = [(sig, None if rows is None else pspec.features(sig, rows.shape[0], dev, name))
                    for sig, rows in pitch]
            out[name].update(numbers(pspec, ctrl, dev))
        taken.append(out)
        return got

    out = []
    for seed in seeds:
        stream_replay.run(Ctx(cell, seed, seconds, False, device), read)
        out.append((seed, taken[-1]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    common.setup_cache_env()
    import torch

    if not torch.cuda.is_available():
        print("bench_port control_stream_pitch: needs a CUDA card", file=sys.stderr)
        return 2
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
                    torch.device("cuda", 0))
    for seed, numbers in rows:
        print(json.dumps({"seed": seed, **numbers}), flush=True)
    summary = {"workload": args.workload,
               "program_max": {k: max(r["program"][k] for _, r in rows) for k in rows[0][1]["program"]}}
    for name in CONTROLS:
        summary[f"{name}_min"] = {k: min(r[name][k] for _, r in rows) for k in rows[0][1][name]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
