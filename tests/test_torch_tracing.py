"""The port's stage recorder and the stages extraction reports, on the CPU.

``profiling.StageTimer``: nesting (per-thread stacks, outermost-only
totals, self time) on a fake clock, and its ``record_function`` ranges in
``profiling.trace``'s Chrome trace.  ``ShardedExtractor``: the
``pad``/``launch`` stages inside each ``dispatch`` and ``wait``/``unpack``
inside each ``collect``, the extent of ``dispatch`` around ``_dispatch``,
nothing recorded without a timer, and ``stats`` (the share of the
computer's input that is not padding).  ``FeatureServer``:
``stats["queue_wait_s"]``.
"""

import contextlib
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import speech_tpu_torch
from speech_tpu_torch import parallel as tpar
from speech_tpu_torch import profiling
from speech_tpu_torch.profiling import StageTimer
from speech_tpu_torch.serve import FeatureServer

import torch_dist_worker as W

SUBSTAGES = {"dispatch": ["pad", "launch"], "collect": ["wait", "unpack"]}


class _Clock:
    """A ``perf_counter`` that moves only when told to."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(profiling.time, "perf_counter", c)
    return c


def _run(timer, clock, plan):
    """Run the nested stages of ``plan`` (``(name, seconds before its
    children, children, seconds after)``) on ``timer``, the clock moving
    by the seconds given."""
    for name, before, children, after in plan:
        with timer.stage(name):
            clock.now += before
            _run(timer, clock, children)
            clock.now += after


PLAN = [("dispatch", 0.5, [("pad", 2.0, [], 0.0), ("launch", 1.0, [], 0.0)], 0.25),
        ("collect", 0.0, [("wait", 3.0, [], 0.0), ("unpack", 0.5, [], 0.0)], 0.0),
        ("dispatch", 0.0, [("pad", 1.0, [], 0.0), ("launch", 1.0, [], 0.0)], 0.0)]


@pytest.mark.parametrize("profiled", [False, True])
def test_stage_timer_nesting(clock, profiled):
    """Outermost-only total and each parent's self time, the same whether
    or not a profiler session makes each stage a ``record_function``."""
    timer = StageTimer()
    with torch.profiler.profile() if profiled else contextlib.nullcontext():
        _run(timer, clock, PLAN)
    assert timer.totals == {"dispatch": 5.75, "pad": 3.0, "launch": 2.0, "collect": 3.5,
                            "wait": 3.0, "unpack": 0.5}
    # the total counts outermost stages only: 5.75 + 3.5, not 18.25
    assert timer.summary() == (
        "stages (9.250s total): dispatch: 5.750s/2x (self 0.750s), "
        "collect: 3.500s/1x (self 0.000s), pad: 3.000s/2x, wait: 3.000s/1x, "
        "launch: 2.000s/2x, unpack: 0.500s/1x")


def test_stage_timer_stacks_are_per_thread(clock):
    """A stage that another thread opens while this thread's stage runs is
    not its child: each thread nests in its own stack."""
    timer = StageTimer()
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait()
        with timer.stage("server"):
            clock.now += 1.0
            with timer.stage("wait"):
                clock.now += 2.0
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with timer.stage("dispatch"):
        opened.set()
        assert done.wait(timeout=30)
        with timer.stage("pad"):
            clock.now += 0.5
    t.join(timeout=30)
    assert not t.is_alive()
    assert timer.totals == {"wait": 2.0, "server": 3.0, "pad": 0.5, "dispatch": 3.5}
    # "dispatch" less its own "pad" only; both outermost stages count once
    assert timer.summary() == (
        "stages (6.500s total): dispatch: 3.500s/1x (self 3.000s), "
        "server: 3.000s/1x (self 1.000s), wait: 2.000s/1x, pad: 0.500s/1x")


def test_stage_timer_under_many_threads():
    """Threads beyond the cores, switching as often as the interpreter
    lets them, record every stage once, each nested in its own thread's
    parent: no update is lost."""
    timer = StageTimer()
    threads, rounds = 3 * (os.cpu_count() or 4), 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with timer.stage("outer"):
                    with timer.stage("inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    n = threads * rounds
    summary = timer.summary()
    assert f"outer: {timer.totals['outer']:.3f}s/{n}x" in summary
    assert f"inner: {timer.totals['inner']:.3f}s/{n}x" in summary
    # only "outer" is outermost, and its self time leaves out every "inner"
    assert timer._outer == pytest.approx(timer.totals["outer"], rel=1e-9)
    assert timer._self["outer"] == pytest.approx(
        timer.totals["outer"] - timer.totals["inner"], rel=1e-6, abs=1e-9)
    assert timer._self["inner"] == pytest.approx(timer.totals["inner"], rel=1e-9)


def test_stage_timer_generator_closes_out_of_turn(clock):
    """A generator suspended inside its stage may be closed after a stage
    opened later on the same thread: both are recorded, and neither's time
    counts as the other's child."""
    timer = StageTimer()

    def gen():
        with timer.stage("read"):
            clock.now += 1.0
            yield 1

    g = gen()
    next(g)
    with timer.stage("write"):
        clock.now += 2.0
        g.close()  # "read" ends inside "write"
        clock.now += 1.0
    assert timer.summary() == "stages (6.000s total): read: 3.000s/1x, write: 3.000s/1x"
    with timer.stage("after"):  # the stack is empty again: outermost
        clock.now += 1.0
    assert timer.summary().startswith("stages (7.000s total): ")


class _Recorder:
    """A ``timer=`` that keeps every stage as ``(name, start, end, parent,
    thread)``, ``parent`` the index of the stage open on the same thread."""

    def __init__(self):
        self.spans, self._local = [], threading.local()

    @contextlib.contextmanager
    def stage(self, name):
        stack = self._local.__dict__.setdefault("stack", [])
        i = len(self.spans)
        self.spans.append([name, time.perf_counter(), None, stack[-1] if stack else None,
                           threading.get_ident()])
        stack.append(i)
        try:
            yield self
        finally:
            stack.pop()
            self.spans[i][2] = time.perf_counter()


def _computer():
    return W.stft_computer(speech_tpu_torch)


def _batches(n=3, seed=3):
    rng = np.random.RandomState(seed)
    return [[rng.randn(int(k)) for k in rng.randint(700, 2400, size=3)] for _ in range(n)]


def _tree(spans):
    """``[(name, [child names])]`` of the outermost spans."""
    return [(s[0], [c[0] for c in spans if c[3] == i])
            for i, s in enumerate(spans) if s[3] is None]


def test_extract_iter_nests_its_stages():
    ex = tpar.ShardedExtractor(_computer())
    calls = []
    for attr in ("_dispatch", "_collect"):
        fn = getattr(ex, attr)

        def timed(*a, _fn=fn, _attr=attr, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                calls.append((_attr, t0, time.perf_counter()))

        setattr(ex, attr, timed)
    timer = _Recorder()
    outs = list(ex.extract_iter(_batches(), timer=timer))
    assert len(outs) == 3
    tree = _tree(timer.spans)
    assert [name for name, _ in tree] == ["dispatch", "dispatch", "collect", "dispatch",
                                          "collect", "collect"]
    assert all(children == SUBSTAGES[name] for name, children in tree)
    assert {s[4] for s in timer.spans} == {threading.get_ident()}
    # "dispatch" encloses the whole of _dispatch and nothing else: the
    # call starts at most a stage's bookkeeping after it and ends before
    # it closes; its two parts lie inside the call
    outer = [(i, s) for i, s in enumerate(timer.spans) if s[3] is None]
    for (i, (name, start, end, _, _)), (attr, c0, c1) in zip(outer, calls):
        assert attr == "_" + name
        assert start <= c0 and c1 <= end
        assert (c0 - start) + (end - c1) < 0.25 * (end - start) + 1e-3
        kids = [s for s in timer.spans if s[3] == i]
        assert c0 <= kids[0][1] and kids[-1][2] <= c1
        assert kids[0][2] <= kids[1][1]


@pytest.mark.parametrize("with_timer", [True, False])
def test_stages_in_the_profilers_trace(tmp_path, with_timer):
    """Under ``profiling.trace`` each stage is a ``record_function`` range
    of its name in the Chrome trace; without a timer there are none."""
    ex = tpar.ShardedExtractor(_computer())
    timer = StageTimer() if with_timer else None
    with profiling.trace(str(tmp_path)):
        outs = list(ex.extract_iter(_batches(2), timer=timer))
    assert len(outs) == 2
    (name,) = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    stages = {"dispatch", "pad", "launch", "collect", "wait", "unpack"}
    if with_timer:
        assert stages <= names
        assert timer.totals.keys() == stages
    else:
        assert not stages & names


def test_extract_iter_without_a_timer_records_nothing(monkeypatch):
    """``timer=None``: every stage is the shared no-op."""
    from speech_tpu_torch.parallel import extract

    seen = []
    monkeypatch.setattr(extract, "_no_stage", lambda name: seen.append(name) or contextlib.nullcontext())
    ex = tpar.ShardedExtractor(_computer())
    assert len(list(ex.extract_iter(_batches(2)))) == 2
    assert seen == ["dispatch", "pad", "launch", "dispatch", "pad", "launch", "collect", "wait",
                    "unpack", "collect", "wait", "unpack"]


def _harness_share(ex, batches, min_batch):
    """The benchmark's own count (``bench_port/kinds/corpus.py``): real
    samples over rows times ``bucket_len`` of each batch's longest row."""
    rows = -(-max(max(len(b) for b in batches), min_batch) // ex.batch_multiple) * ex.batch_multiple
    useful = sum(len(s) for b in batches for s in b)
    kernel = sum(rows * ex.bucket_len(max(len(s) for s in b)) for b in batches)
    return useful / kernel


@pytest.mark.parametrize("bucket,min_batch", [("pow2", 0), ("pow2", 8), ("fine", 4)])
def test_extractor_stats_count_the_padding(bucket, min_batch):
    ex = tpar.ShardedExtractor(_computer(), bucket=bucket)
    batches = [b for b in _batches(4, seed=11) if len(b) == 3]
    assert ex.stats == {"batches": 0, "rows": 0, "samples": 0, "kernel_samples": 0}
    list(ex.extract_iter(batches, min_batch=min_batch))
    st = ex.stats
    rows = max(3, min_batch)
    assert st["batches"] == len(batches) and st["rows"] == rows * len(batches)
    assert st["samples"] == sum(len(s) for b in batches for s in b)
    assert st["samples"] / st["kernel_samples"] == pytest.approx(
        _harness_share(ex, batches, min_batch), rel=1e-12)
    ex.extract(batches[0])  # extract counts too
    assert st["batches"] == len(batches) + 1


def test_feature_server_counts_its_queue_wait():
    sigs = [s for b in _batches(2, seed=5) for s in b]
    with FeatureServer(_computer(), max_batch=4, max_wait_ms=40.0) as server:
        server.warmup([len(s) for s in sigs])
        warm = server.stats["queue_wait_s"]
        t0 = time.perf_counter()
        outs = server.extract_many(sigs)
        wall = time.perf_counter() - t0
        lone = server.stats["queue_wait_s"]
        server.extract(sigs[0])  # a lone request waits the whole max_wait
        stats = dict(server.stats)
    assert len(outs) == len(sigs) and stats["completed"] == len(sigs) + 1
    assert warm == 0.0  # warm-up batches carry no request
    assert 0.0 < lone <= len(sigs) * wall
    assert stats["queue_wait_s"] - lone >= 0.035
