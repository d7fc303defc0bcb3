"""Each fault a cell can have, planted under its timed path on the CPU,
makes ``correct`` come out false; the same run without it is correct.
The harness runs as it does on the card, but for its look for one."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from bench_port import common

from small import cpu_run

CORPUS, SERVE, STREAM = ("fbank40-kaldi-double.corpus", "fbank80-wenet-float.serve",
                         "fbank80-wenet-float.stream")


def _half_batch(monkeypatch):
    """Half of every batch's requests left out: silence reaches the kernel
    in their place (a batch of one loses its one)."""
    import numpy as np
    from speech_tpu_torch.parallel.extract import ShardedExtractor

    dispatch = ShardedExtractor._dispatch

    def halved(self, signals, min_batch=0):
        keep = len(signals) // 2
        signals = list(signals[:keep]) + [np.zeros_like(s) for s in signals[keep:]]
        return dispatch(self, signals, min_batch)

    monkeypatch.setattr(ShardedExtractor, "_dispatch", halved)


def _altered(monkeypatch):
    """One feature of every batch altered where it is produced."""
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.streaming import StreamingSTFT

    padded_feats = STFTFrameComputer._padded_feats
    stream_feats = StreamingSTFT._feats

    def bump(feats):
        feats = feats.clone()
        feats[..., 0, 0] += 0.1
        return feats

    monkeypatch.setattr(STFTFrameComputer, "_padded_feats",
                        lambda self, padded, n: bump(padded_feats(self, padded, n)))
    monkeypatch.setattr(StreamingSTFT, "_feats", lambda self, frames: bump(stream_feats(self, frames)))


def _stale_state(monkeypatch):
    """A stream tick that returns its state unchanged."""
    from speech_tpu_torch.streaming import StreamingSTFT

    process = StreamingSTFT._process_streams

    def stale(self, state, chunk, v):
        _, feats, nf = process(self, state, chunk, v)
        return state, feats, nf

    monkeypatch.setattr(StreamingSTFT, "_process_streams", stale)


FAULTS = {"half_batch": _half_batch, "altered": _altered, "stale_state": _stale_state}


@pytest.mark.parametrize("name,fault", [
    (CORPUS, None), (CORPUS, "half_batch"), (CORPUS, "altered"),
    (SERVE, None), (SERVE, "half_batch"), (SERVE, "altered"),
    (STREAM, None), (STREAM, "stale_state"), (STREAM, "altered"),
])
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    if fault is not None:
        FAULTS[fault](monkeypatch)
    _, out = cpu_run(name, seconds=1.0)
    assert out["correct"] is (fault is None), out["checks"]


RANK = r"""
import json, sys, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from small import small_cell
from bench_port.run import Ctx, result, run_cell
rank, port, fault = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if fault == "exchange":
    # the gather between cards left out: every card keeps its own rows,
    # the others' places hold zeros
    from torch.distributed.tensor import DTensor
    def local_only(self, *a, **k):
        mine = self.to_local()
        out = mine.new_zeros(self.shape)
        start = self.device_mesh.get_local_rank() * mine.shape[0]
        out[start: start + mine.shape[0]] = mine
        return out
    DTensor.full_tensor = local_only
name = "fbank40-kaldi-double.corpus-4card"
ctx = Ctx(small_cell(name), 20261018, 1.0, False, torch.device("cpu"), rank, 4, port)
out = result(ctx, run_cell(ctx), name)
import torch.distributed as dist
dist.barrier(group=ctx.control)
dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
"""


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_four_ranks_without_the_exchange_are_not_correct(fault):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = RANK.format(root=str(common.ROOT), tests=str(common.HERE / "tests"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(fault)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    out = json.loads(outs[0][0].strip().splitlines()[-1])
    assert out["device"]["count"] == 4
    assert out["correct"] is (fault is None), out["checks"]
