"""The readers of the extractor's nested stages and of the feature server's
queue wait, on synthetic runs and traces, and the program's count of its
padding against the harness's own."""

import pytest
import torch

from bench_port import common
from bench_port.run import _reader
from bench_port.trace import Trace

from small import cpu_run

SPAN_READERS = [("extract.pad_ms", "extract.pad"), ("extract.launch_ms", "extract.launch"),
                ("extract.wait_ms", "extract.wait"), ("extract.unpack_ms", "extract.unpack")]


def _run(t0=10.0, t1=20.0):
    run = common.Run({"route": "B2", "tier": "double"}, {}, None)
    run.t0, run.t1 = t0, t1
    return run


@pytest.mark.parametrize("metric,span", SPAN_READERS)
def test_span_readers_take_the_mean_of_the_window(metric, span):
    run = _run()
    read = _reader(metric)
    assert read(run) is None  # no spans: nothing to read, never a 0
    run.spans.add("extract.dispatch", 11.0, 11.5)  # another stage is not read
    assert read(run) is None
    run.spans.add(span, 9.99, 10.5)  # starts before the window
    run.spans.add(span, 11.0, 11.002)
    run.spans.add(span, 12.0, 12.006)
    run.spans.add(span, 20.0, 20.1)  # starts at the window's end
    assert read(run) == pytest.approx(4.0)


def _pad_run(ops, pads, lo=0.0, hi=10.0):
    run = _run(lo, hi)
    run.trace = Trace(lo, hi, ops)
    for a, b in pads:
        run.spans.add("extract.pad", a, b)
    return run


def test_idle_in_pad_on_hand_made_intervals():
    read = _reader("extract.idle_in_pad")
    ops = [(1.0, 2.0, "k"), (4.0, 5.0, "Memcpy HtoD"), (4.5, 6.0, "k"), (9.0, 11.0, "k")]
    # idle: [0, 1), [2, 4), [6, 9); pads cover 0.5-1.5 (0.5 idle), 3-7 (1 + 1
    # idle, overlapping pads merged), 8.5-12 (0.5 idle, clipped to the window)
    pads = [(0.5, 1.5), (3.0, 6.5), (5.0, 7.0), (8.5, 12.0), (-5.0, -4.0)]
    assert read(_pad_run(ops, pads)) == pytest.approx(100.0 * 3.0 / 10.0)
    # a pad wholly over device work reads 0, a pad over the whole window
    # reads the whole idle share
    assert read(_pad_run(ops, [(1.2, 1.8)])) == 0.0
    whole = _pad_run(ops, [(-1.0, 11.0)])
    assert read(whole) == pytest.approx(_reader("device.idle.corpus")(whole))


@pytest.mark.parametrize("case", ["no trace", "no kernels", "no pads", "pads outside"])
def test_idle_in_pad_reads_nothing_where_there_is_nothing(case):
    ops = [(1.0, 2.0, "k")]
    pads = [(0.0, 0.5)]
    if case == "no kernels":
        ops = [(1.0, 2.0, "Memcpy DtoH")]
    elif case == "no pads":
        pads = []
    elif case == "pads outside":
        pads = [(11.0, 12.0)]
    run = _pad_run(ops, pads)
    if case == "no trace":
        run.trace = None
    assert _reader("extract.idle_in_pad")(run) is None


def test_queue_wait_reader_on_a_feature_server():
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.serve import FeatureServer

    import numpy as np

    comp = STFTFrameComputer({"name": "fbank", "num_filts": 10, "sampling_rate": 16000},
                             frame_length_ms=25, frame_shift_ms=10, device="cpu")
    run = _run()
    read = _reader("serve.queue_wait_ms")
    assert read(run) is None
    rng = np.random.RandomState(1)
    with FeatureServer(comp, max_batch=4, max_wait_ms=30.0) as server:
        server.warmup([4000])
        stats0 = dict(server.stats)
        server.extract(rng.randn(4000))  # alone: it waits out max_wait
        stats1 = dict(server.stats)
    run.counters = {k: stats1[k] - stats0[k] for k in stats1}  # as kinds/serve.py takes them
    assert run.counters["completed"] == 1
    assert 25.0 <= read(run) == pytest.approx(1e3 * run.counters["queue_wait_s"])
    run.counters = {"completed": 0, "queue_wait_s": 0.0}
    assert read(run) is None


def test_program_counts_the_padding_the_harness_computes(monkeypatch):
    """``ShardedExtractor.stats`` over the window's batches gives the share
    that ``extract.useful_share`` computes from ``bucket_len``."""
    from speech_tpu_torch.parallel import ShardedExtractor

    from bench_port.run import Ctx

    made, at_start = [], {}
    init, start = ShardedExtractor.__init__, Ctx.start_window

    def keep(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    def snapshot(self):
        at_start.update(made[-1].stats)
        return start(self)

    monkeypatch.setattr(ShardedExtractor, "__init__", keep)
    monkeypatch.setattr(Ctx, "start_window", snapshot)
    ctx, out = cpu_run("fbank40-kaldi-double.corpus", seconds=1.0, trace=True)
    assert out["correct"]
    st = {k: made[-1].stats[k] - at_start[k] for k in at_start}
    assert st["batches"] == ctx.run.values["batches"] > 0
    assert st["samples"] == ctx.run.values["useful_samples"]
    assert st["kernel_samples"] == ctx.run.values["kernel_samples"]
    assert 100.0 * st["samples"] / st["kernel_samples"] == pytest.approx(
        _reader("extract.useful_share")(ctx.run), rel=1e-12)
    # the traced run reports the four stages (on the CPU the trace has no
    # device operation, so the card's idle share in padding is silent)
    for metric, _ in SPAN_READERS:
        assert out["metrics"][metric]["value"] > 0
    assert "extract.idle_in_pad" not in out["metrics"]
    assert torch.device(ctx.device).type == "cpu"
