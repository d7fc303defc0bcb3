"""The harness on the CPU: files found by name, the contract of
``BENCHMARK.json``, seeded traffic, open-loop latency, the import guard,
the trace's reduction, and the command's refusal without a card."""

import json
import math
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bench_port import common, traffic
from bench_port.run import _reader
from bench_port.trace import Trace, gaps, union_s

from small import DRAFTS, cpu_run

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["workloads"]
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
    for w in CELLS:
        assert len(common.metrics_of(w, False)) >= 2 and common.metrics_of(w, True)


@pytest.mark.parametrize("name", CELLS)
def test_cells_configs_mixes_and_readers_are_found_by_name(name):
    cell = common.cell(name)
    assert (common.HERE / "cells" / f"{name}.json").exists()
    assert (common.HERE / "kinds" / f"{cell['mix']['kind']}.py").exists()
    assert cell["config"]["computer"]["name"] == "stft"
    for trace in (False, True):
        for m in common.metrics_of(name, trace):
            assert callable(_reader(m["name"]))


def test_configs_lie_under_paths_and_name_their_source():
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/configs/")
        data = common.load_json(common.ROOT / c["file"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []


def test_traffic_is_the_seeds():
    audio = common.cell(CELLS[0])["mix"]["audio"]
    a = traffic.synth([800, 1200], 2**33 + 5, "t", audio, 16000, "cpu")
    b = traffic.synth([800, 1200], 2**33 + 5, "t", audio, 16000, "cpu")
    c = traffic.synth([800, 1200], 2**33 + 6, "t", audio, 16000, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert [x.size for x in a] == [800, 1200] and a[0].dtype == np.int16
    f = traffic.synth([800], 7, "t", {**audio, "pcm": None, "rms": 0.05}, 16000, "cpu")
    assert f[0].dtype == np.float32 and abs(float(np.sqrt(np.mean(f[0] ** 2))) - 0.05) < 0.02
    # every seed gets the same set of sizes and gaps, in another order
    lens = traffic.uniform_lengths(64, 2.0, 20.0, 16000)
    s1, s2 = traffic.shuffled(lens, 1, "x"), traffic.shuffled(lens, 2, "x")
    assert not np.array_equal(s1, s2) and np.array_equal(np.sort(s1), np.sort(s2))
    gaps_ = traffic.exp_gaps(1000, 50.0)
    assert abs(gaps_.mean() * 50.0 - 1.0) < 0.01


def test_open_loop_latency_runs_from_due_times(monkeypatch):
    """A scheduler held back 40 ms at every request: each request's
    latency still counts from its due time, so none reads under 40 ms."""
    from speech_tpu_torch.serve import FeatureServer

    submit = FeatureServer.submit

    def late(self, signal):
        time.sleep(0.04)
        return submit(self, signal)

    monkeypatch.setattr(FeatureServer, "submit", late)
    ctx, out = cpu_run("fbank80-wenet-float.serve", seconds=1.0)
    lat = ctx.run.values["latency_s"]
    assert out["correct"] and len(lat) == out["attempted"] > 5
    assert min(lat) >= 0.04
    assert min(ctx.run.lateness[1:]) > 0.0
    assert _reader("request_p95_ms")(ctx.run) >= 40.0


def test_import_guard_compares_whole_top_level_names():
    mods = ["jax.numpy", "jaxlib", "flax.linen", "speech_tpu.ops.stft", "speech_tpu_torch.serve",
            "speech_tpu_torchx", "numpy", "jaxtyping"]
    assert common.forbidden_modules(mods) == ["flax", "jax", "jaxlib", "speech_tpu"]
    assert common.forbidden_modules(["speech_tpu_torch", "speech_tpu_torch.ops"]) == []


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from small import cpu_run\n"
            "from bench_port import common\n"
            "ctx, out = cpu_run('fbank40-kaldi-double.corpus', seconds=0.5)\n"
            "print(json.dumps([out['correct'], common.forbidden_modules()]))\n"
            % (str(common.ROOT), str(common.HERE / "tests")))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=common.ROOT)
    assert got.returncode == 0, got.stderr[-2000:]
    assert json.loads(got.stdout.strip().splitlines()[-1]) == [True, []]


def _command(cwd, script):
    return subprocess.run(
        [sys.executable, str(script), "--workload", CELLS[0], "--seed", "3000000017",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for machines without one")
    got = _command(common.ROOT, common.HERE / "run.py")
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_the_command_fails_in_a_tree_of_the_benchmark_alone(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _command(tmp_path, tmp_path / "bench_port" / "run.py")
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_trace_reduction():
    assert union_s([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert union_s([(0, 2), (1, 3)], 1.5, 2.5) == 1.0
    assert gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    tr = Trace(0.0, 10.0, [(1, 2, "k"), (4, 5, "Memcpy HtoD"), (8, 12, "k")])
    assert tr.busy_s == 4 and tr.window_s == 10 and tr.kernel_s == 3
    assert len(tr.kernels) == 2 and tr.top_ops()[0] == ["k", 3]
    spans = common.Spans()
    spans.add("serve._launch", 2.0, 4.0)
    spans.add("stream.step", 5.0, 8.0)
    assert tr.idle_by_span(spans, ("serve._launch", "stream.step")) == [
        ["stream.step", 3.0], ["serve._launch", 2.0], ["none", 1.0]]


def test_readers_read_what_the_run_recorded():
    run = common.Run({"route": "B2", "tier": "double"}, {}, None)
    run.t0, run.t1 = 0.0, 10.0
    run.values = {"latency_s": [0.01] * 95 + [math.inf] * 5, "audio_s": 500.0, "elapsed_s": 2.0,
                  "chunk_latency_s": [0.002, 0.004], "useful_samples": 1.0,
                  "kernel_samples": 4.0}
    run.counters = {"completed": 640, "batches": 20}
    run.setup_s = 12.5
    for k in range(4):
        run.spans.add("extract.dispatch", k, k + 0.02)
    assert _reader("request_p95_ms")(run) == pytest.approx(10.0)
    assert _reader("chunk_p95_ms")(run) == pytest.approx(4.0)
    assert _reader("audio_s_per_s")(run) == 250.0
    assert _reader("setup_s")(run) == 12.5
    assert _reader("extract.useful_share")(run) == 25.0
    assert _reader("serve.rows_per_batch")(run) == 32.0
    assert _reader("extract.dispatch_ms")(run) == pytest.approx(20.0)
    # nothing to read: no value, never a 0
    assert _reader("kernel.feats_roofline")(run) is None
    assert _reader("device.idle.serve")(run) is None
    assert _reader("stream.launches_per_tick")(run) is None


@pytest.mark.parametrize("name", [c for c in CELLS + list(DRAFTS) if not c.endswith("4card")])
def test_a_cell_runs_on_the_cpu_and_is_correct(name):
    _, out = cpu_run(name, trace=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in common.metrics_of(name, True)}
    # on the CPU the trace has no device operation: the roofline is silent
    assert set(out["metrics"]) <= want and out["device"]["window_s"] > 0
    assert threading.active_count() < 50


def test_stream_sessions_opened_late_get_their_own_audio(monkeypatch):
    """Closes that lag by more than a whole session, as on a slow host,
    leave the next sessions' chunks waiting in their lane: each session
    opens with its own chunks, and its rows stay correct."""
    from speech_tpu_torch.serve import StreamServer

    import small

    close = StreamServer.close_session

    def lagging(self, handle):
        time.sleep(2.5)
        return close(self, handle)

    monkeypatch.setattr(StreamServer, "close_session", lagging)
    monkeypatch.setitem(small.SMALL, "stream", {**small.SMALL["stream"], "check_sessions": 64})
    ctx, out = cpu_run("fbank80-wenet-float.stream", seconds=4.0)
    assert out["correct"], out["checks"]
    assert out["checks"]["row_count_mismatches"]["value"] == 0
