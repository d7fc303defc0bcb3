"""Run one cell of the benchmark of ``speech_tpu_torch`` and print its
result as the last line of standard output.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads`` of ``BENCHMARK.json``) names a configuration
(``bench_port/configs/``) and a traffic mix (``bench_port/mixes/``); its
own file (``bench_port/cells/<name>.json``) holds the load that was
chosen for the pairing and the limits of its comparison.  The run builds
the program on the card, makes its inputs from the seed, warms every shape
the traffic uses, measures for ``--seconds``, reads its metrics through
the readers of ``bench_port/metrics/`` (the end-to-end ones, or with
``--trace 1`` the per-layer ones over a traced part of the window), and
compares a sample of what the window produced with the plain reference.

It needs as many CUDA cards as the cell asks for and fails without them.
A cell on several cards starts one process a card (ranks 1.. from this
one, which is rank 0 and prints the result).
"""

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import common  # noqa: E402

SPAN_LABELS = ("extract.dispatch", "extract.collect", "serve._launch", "serve._readback",
               "stream.step")


def process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (to 10 ms)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, AttributeError):
        age = 0.0
    return time.perf_counter() - age


class Ctx:
    """One rank's view of a run, handed to the driver of the cell's kind."""

    def __init__(self, cell, seed, seconds, trace, device, rank=0, world=1, port=0, t_start=None):
        from bench_port.reference.fbank import FbankSpec

        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), bool(trace)
        self.config, self.mix = cell["config"], cell["mix"]
        self.limits = cell["cell"].get("limits", {})
        self.spec = FbankSpec(self.config["computer"])
        self.run = common.Run(self.config, self.mix, self.spec)
        self.device, self.rank, self.world = device, rank, world
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.mesh = self.control = None
        if world > 1:
            from bench_port import program

            self.mesh, self.control = program.start_group(rank, world, port, device)

    def tracer(self):
        if not self.trace:
            return None
        from bench_port.trace import Tracer

        return Tracer(self.device)

    def start_window(self):
        """The measured window starts now: returns its start, and records
        the set-up's length.  Everything made in set-up (the traffic's
        inputs and plan, the program's built state) moves out of the
        garbage collector's generations, so that the benchmark's own data
        does not lengthen the collections the program's work triggers."""
        gc.freeze()
        t0 = time.perf_counter()
        self.run.t0, self.run.setup_s = t0, t0 - self.t_start
        return t0

    def agree(self, code: int) -> int:
        """Rank 0's ``code``, on every rank."""
        if self.world == 1:
            return code
        import torch
        import torch.distributed as dist

        t = torch.tensor([code], dtype=torch.int64)
        dist.broadcast(t, 0, group=self.control)
        return int(t.item())

    def reduce(self, value: float, op: str) -> float:
        if self.world == 1:
            return value
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.control)
        return float(t.item())

    def barrier(self):
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self.control)

    def memory_peak(self) -> int:
        """The peak of device memory on the fullest card of the run."""
        import torch

        local = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        return int(self.reduce(local, "max"))


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_"), common.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(name: str, run, trace: bool):
    """``{metric: {"value", "unit"}}`` of the cell's end-to-end metrics
    (``trace`` false) or per-layer ones (a reader that finds nothing to
    read leaves its metric out; an end-to-end one may not)."""
    out = {}
    for m in common.metrics_of(name, trace):
        value = _reader(m["name"])(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"no value for end-to-end metric {m['name']!r}")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(ctx):
    """Drive the cell's traffic; returns the finished :class:`common.Run`."""
    importlib.import_module(f"bench_port.kinds.{ctx.mix['kind']}").run(ctx)
    return ctx.run


def _finite(x):
    return x if math.isfinite(x) else 1e300


def result(ctx, run, kind_name: str):
    """The result line's object (``checks`` last)."""
    import torch

    dev = ctx.device
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": ctx.world,
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    out = {
        "correct": bool(run.correct),
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": read_metrics(kind_name, run, ctx.trace),
        "device": device,
    }
    if ctx.trace:
        tr = run.trace
        busy, window = (tr.busy_s, tr.window_s) if tr is not None else (0.0, 0.0)
        device["busy_s"] = ctx.reduce(busy, "sum") / ctx.world
        device["window_s"] = ctx.reduce(window, "sum") / ctx.world
        if tr is not None:
            out["breakdown"] = {"device_ops": tr.top_ops(10),
                                "idle_gaps": tr.idle_by_span(run.spans, SPAN_LABELS, 10)}
    out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in run.checks.items()}
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(args, world, port):
    """Ranks ``1 .. world - 1`` of a cell on several cards."""
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
               str(args.trace), "--rank", str(r), "--world", str(world), "--port", str(port)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL))
    return procs


def _watch(procs, stop):
    """End the run when a rank fails: the others would wait for it."""
    while not stop.is_set():
        for p in procs:
            if p.poll() not in (None, 0):
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                print(f"bench_port: rank process exited with {p.returncode}", file=sys.stderr,
                      flush=True)
                os._exit(1)
        stop.wait(0.5)


def _end_ranks(procs, timeout=120):
    rc = 0
    for p in procs:
        try:
            rc |= p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc |= 1
    return rc


def main(argv=None):
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    cell = common.cell(args.workload)
    common.setup_cache_env()
    import torch

    torch.set_num_threads(common.HOST_THREADS)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t = time.perf_counter()
    import speech_tpu_torch  # noqa: F401  -- the program's import, timed

    import_s = time.perf_counter() - t
    rank, world, port = args.rank or 0, chips, args.port
    procs, stop = [], threading.Event()
    if chips > 1 and args.rank is None:
        port = _free_port()
        procs = _spawn_ranks(args, world, port)
        threading.Thread(target=_watch, args=(procs, stop), daemon=True).start()
    try:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        ctx = Ctx(cell, args.seed, args.seconds, args.trace, device, rank, world, port, t_start)
        run = run_cell(ctx)
        out = result(ctx, run, args.workload)
        if world > 1:
            import torch.distributed as dist

            dist.barrier(group=ctx.control)
            dist.destroy_process_group()
    finally:
        stop.set()
        rc = _end_ranks(procs)
    if rank != 0:
        return 0
    if rc:
        print(f"bench_port: a rank process failed ({rc})", file=sys.stderr)
        return 1
    found = common.forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    late = sorted(run.lateness) or [0.0]
    info = {
        "workload": args.workload, "seed": args.seed, "import_s": import_s,
        "card": _card(),
        "lateness_ms": {"p50": statistics.median(late) * 1e3,
                        "p99": common.percentile(late, 99) * 1e3, "max": late[-1] * 1e3},
        "values": {k: v for k, v in run.values.items() if not isinstance(v, list)},
        "counters": run.counters,
        "timeline": run.values.get("timeline"),
    }
    print("bench_port info " + json.dumps(info), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


if __name__ == "__main__":
    sys.exit(main())
