"""CPU runs of the benchmark's cells at sizes a test can hold (the test
files import this module by name: pytest puts this directory on the path)."""

import torch

from bench_port import common

# each mix cut to a test's size (the traffic's shape is kept)
SMALL = {
    "corpus": {"batch": 4, "min_batch": 4, "pool_batches": 2, "seconds_min": 0.5,
               "seconds_max": 2.0, "check_batches": 2, "trace_seconds": 0.5},
    "corpus-4card": {"batch": 8, "min_batch": 8, "pool_batches": 2, "seconds_min": 0.5,
                     "seconds_max": 2.0, "check_batches": 2, "trace_seconds": 0.5},
    "serve": {"pool": 16, "seconds_min": 0.5, "seconds_max": 2.0, "rate_per_s": 20.0,
              "check_requests": 8, "max_batch": 8, "trace_seconds": 0.5, "settle_s": 30.0},
    "stream": {"sessions": 4, "seconds_min": 1.0, "seconds_max": 2.0, "check_sessions": 4,
               "trace_seconds": 0.5, "settle_s": 30.0},
}


# cells whose drivers, mixes and readers are kept and tested here at a
# test's size, but that BENCHMARK.json does not list yet (PERF.md, Open
# questions)
DRAFTS = {
    "fbank80-wenet-float.serve": {"config": "fbank80-wenet-float", "traffic": "serve",
                                  "chips": 1},
    "fbank80-wenet-float.stream": {"config": "fbank80-wenet-float", "traffic": "stream",
                                   "chips": 1},
    "fbank40-kaldi-double.corpus-4card": {"config": "fbank40-kaldi-double",
                                          "traffic": "corpus-4card", "chips": 4},
}


def shrink(cell):
    """``cell`` (of :func:`bench_port.common.cell`) at a test's size."""
    cell["mix"].update(SMALL[cell["traffic"]])
    return cell


def small_cell(name):
    return shrink(common.cell(name, DRAFTS.get(name)))


def cpu_run(name, seed=20261017, seconds=1.5, trace=False):
    """One run of cell ``name`` on the CPU at a test's size: its Ctx and
    result line."""
    from bench_port.run import Ctx, result, run_cell

    ctx = Ctx(small_cell(name), seed, seconds, trace, torch.device("cpu"))
    run = run_cell(ctx)
    return ctx, result(ctx, run, name)
