"""What every part of the benchmark shares: where it lives, the cell it
runs, the import guard, host spans and the run's record."""

import contextlib
import json
import math
import os
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache the program or the benchmark writes: inside the checkout, at
# a fixed path, so that only a cell's first run in a checkout builds
CACHE = ROOT / ".bench_port_cache"
AOT_STORE = CACHE / "aot"
# the top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "speech_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, entry=None):
    """The ``workloads`` entry ``name`` of ``BENCHMARK.json`` (or ``entry``,
    ``{"config", "traffic", "chips"}``, for a cell it does not list) with
    its configuration, traffic mix and the cell's own file merged in:
    ``{"name", "traffic", "chips", "config": {...}, "mix": {...}, "cell": {...}}``."""
    bench = benchmark()
    if entry is None:
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = entries[name]
    files = {c["name"]: ROOT / c["file"] for c in bench["configs"]}
    config = load_json(files.get(entry["config"], HERE / "configs" / f"{entry['config']}.json"))
    mix = load_json(HERE / "mixes" / f"{entry['traffic']}.json")
    own = HERE / "cells" / f"{name}.json"
    return {
        "name": name,
        "traffic": entry["traffic"],
        "chips": int(entry["chips"]),
        "config": config,
        "mix": {**mix, **(load_json(own).get("load", {}) if own.exists() else {})},
        "cell": load_json(own) if own.exists() else {},
    }


def metrics_of(name: str, trace: bool):
    """The metrics a run of workload ``name`` reports: the end-to-end ones
    without the trace, the per-layer ones with it."""
    bench = benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or name in m["workloads"]]


# host threads of the CPU libraries' pools: the timed paths pad and copy in
# numpy on their own threads and hand the card its work, so a pool's
# workers would only spin beside them on the host the cell measures
HOST_THREADS = 1


def setup_cache_env(env=os.environ):
    """Point the build and kernel caches PyTorch and Triton read at
    directories inside the checkout, and keep the CPU libraries' thread
    pools (OpenMP, MKL, OpenBLAS) at ``HOST_THREADS``; before torch is
    imported."""
    env["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    env.setdefault("USE_FLAX", "0")
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        env[name] = str(HOST_THREADS)


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (the part before the first
    dot), compared whole, is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by nearest rank (``inf`` counts as a miss
    and sorts last)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    k = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
    return vals[k]


def timeline(times, values, t0, t1, step=1.0, stat=None):
    """Per ``step`` seconds of ``[t0, t1)``: the sum of ``values`` whose
    ``times`` fall in it, or ``stat`` of them (for the earlier lines a run
    prints: how a window's numbers moved within it)."""
    n = max(1, int(math.ceil((t1 - t0) / step)))
    bins = [[] for _ in range(n)]
    for t, v in zip(times, values):
        k = int((t - t0) // step)
        if 0 <= k < n:
            bins[k].append(v)
    if stat is None:
        return [sum(b) for b in bins]
    return [stat(b) if b else None for b in bins]


class Spans:
    """Host spans ``(name, start, end)`` on ``time.perf_counter``, from any
    thread, kept in memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def add(self, name, t0, t1):
        with self._lock:
            self.items.append((name, t0, t1))

    def wrap(self, obj, attr: str, name: str):
        """Time every call of ``obj.attr`` as span ``name``."""
        fn = getattr(obj, attr)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.add(name, t0, time.perf_counter())

        setattr(obj, attr, timed)

    def of(self, name, t0=-math.inf, t1=math.inf):
        """The spans ``name`` that start in ``[t0, t1)``."""
        with self._lock:
            return [(a, b) for n, a, b in self.items if n == name and t0 <= a < t1]


class StageTimer:
    """A ``timer=`` for ``ShardedExtractor.extract_iter``: its ``stage(name)``
    blocks become spans ``prefix + name`` (copied from the program's
    ``profiling.StageTimer``, keeping each span, not only the totals)."""

    def __init__(self, spans: Spans, prefix: str):
        self._spans, self._prefix = spans, prefix

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._spans.add(self._prefix + name, t0, time.perf_counter())


class Run:
    """What one run measured, for the metric readers of ``metrics/``.

    ``setup_s``; the window's ``t0``/``t1`` (``perf_counter``); ``spans``;
    ``counters`` (the program's, read at the window's ends); ``values``
    (numbers the driver of the cell's traffic works out: audio seconds,
    latencies); ``trace`` (a :class:`bench_port.trace.Trace` of the traced
    window, or None); ``work`` (the traced window's valid frames and
    samples, for the roofline); ``spec``, ``config``, ``mix``.
    """

    def __init__(self, config, mix, spec):
        self.config, self.mix, self.spec = config, mix, spec
        self.spans = Spans()
        self.counters = {}
        self.values = {}
        self.trace = None
        self.work = None
        self.setup_s = None
        self.t0 = self.t1 = None
        self.attempted = 0
        self.failed = 0
        self.checks = {}
        self.correct = False
        self.memory_peak_bytes = 0
        self.lateness = []
