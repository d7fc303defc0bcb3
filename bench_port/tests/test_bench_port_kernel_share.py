"""The reader of ``pitch.kernel_share`` on synthetic runs: the share of the
pitch tracker's Viterbi steps that its hand-written kernel ran, and nothing
where the program has no such counter."""

import pytest

from bench_port import common
from bench_port.run import _reader


@pytest.mark.parametrize(
    "counters,want",
    [({"pitch_steps": 400, "pitch_kernel_steps": 400}, 100.0),
     ({"pitch_steps": 400, "pitch_kernel_steps": 100}, 25.0),
     ({"pitch_steps": 400, "pitch_kernel_steps": 0}, 0.0),
     ({"pitch_steps": 400, "pitch_valid_frames": 300}, None),
     ({"pitch_steps": 0, "pitch_kernel_steps": 0}, None),
     ({}, None)],
    ids=["all", "a quarter", "none", "no counter", "no steps", "no pitch"])
def test_kernel_share_reads_the_kernels_steps(counters, want):
    """``pitch.kernel_share``: the kernel's steps over the Viterbi's, in
    percent; nothing where the program has no such counter (a parent
    without the kernel) or stepped over nothing."""
    run = common.Run({"route": "B2", "tier": "double"}, {}, None)
    run.t0, run.t1 = 10.0, 20.0
    run.counters = counters
    got = _reader("pitch.kernel_share")(run)
    assert got is None if want is None else got == pytest.approx(want)
