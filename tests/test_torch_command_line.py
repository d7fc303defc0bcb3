"""speech_tpu_torch.command_line against speech_tpu.command_line, on the CPU.

Twins of ``tests/test_command_line.py``, the CLI cases of
``tests/test_nn_export.py`` (``--learned-params``) and
``tests/test_presets.py`` (a preset name as the config), plus the port's own
contracts: each parser takes exactly the reference parser's option strings,
the AOT store flags are refused, ``python -m speech_tpu_torch.command_line``
dispatches, ``profiling.trace`` writes a trace, the ``.pt`` directories of
the two packages invert through either package's
``torch-feat-dir-to-signals``, and at world size 2 (gloo) only rank 0
writes.

Each twin runs both packages' command on the same map, wavs and seed: the
JAX config as it is, the port's the same config plus ``"device": "cpu"``.
Tolerances: float tiers 1e-4 (``tests/test_pallas.py:55``), ``--seed``
dither 1e-4 (the same numpy draws); pitch columns 2e-3 (the reference's own
CLI tolerance); recovered wavs within 1e-4 of full scale; text, manifest and
file-count outputs and return codes equal.
"""

import argparse
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from speech_tpu import command_line as jcli
from speech_tpu_torch import command_line as tcli

import torch_dist_worker as W

TOL = 1e-4
TOL_PITCH = 2e-3  # tests/test_command_line.py::test_signals_to_torch_feat_dir_pitch
TOL_WAV = 1e-4  # of int16 full scale

COMPUTER = {
    "name": "stft",
    "bank": {"name": "fbank", "num_filts": 10, "sampling_rate": 8000},
    "frame_length_ms": 25,
    "frame_shift_ms": 10,
}
CFG, OUT = object(), object()  # placeholders for each package's config / output


def _config(cli, cfg):
    return cfg if cli is jcli else {**cfg, "device": "cpu"}


def both(command, args, tmp, tag, cfg=COMPUTER):
    """``command`` of each package on ``args`` (``CFG``/``OUT`` replaced by
    its config and by ``tmp/<tag>_<package>``): ``{package: (rc, out)}``."""
    runs = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        out = os.path.join(str(tmp), f"{tag}_{name}")
        argv = [
            json.dumps(_config(cli, cfg)) if a is CFG else out if a is OUT else a
            for a in args
        ]
        runs[name] = (getattr(cli, command)(argv), out)
    return runs


def load_dir(d):
    return {f: torch.load(os.path.join(d, f)).numpy() for f in sorted(os.listdir(d))}


def assert_dirs_close(want_dir, got_dir, tol=TOL):
    want, got = load_dir(want_dir), load_dir(got_dir)
    assert list(got) == list(want)
    for f in want:
        assert got[f].dtype == np.float32 and got[f].shape == want[f].shape, f
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=tol, err_msg=f)


def read_wav(path):
    with wave.open(path) as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        rate = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return rate, pcm


def write_wav(path, pcm, rate):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())


def assert_wav_dirs_close(want_dir, got_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for f in names:
        rw, w = read_wav(os.path.join(want_dir, f))
        rg, g = read_wav(os.path.join(got_dir, f))
        assert rg == rw and g.shape == w.shape, f
        err = np.abs(g.astype(np.int64) - w).max() / 32768.0
        assert err <= TOL_WAV, (f, err)


@pytest.fixture
def wav_dir(tmp_path):
    """20 random 16-bit wavs + a map file (tests/test_command_line.py)."""
    rng = np.random.RandomState(50)
    d = tmp_path / "wavs"
    d.mkdir()
    map_path = str(tmp_path / "map.txt")
    with open(map_path, "w") as mf:
        for i in range(20):
            n = rng.randint(1600, 8000)
            path = str(d / f"utt{i:02d}.wav")
            write_wav(path, (rng.randn(n) * 1000).astype(np.int16), 8000)
            mf.write(f"utt{i:02d} {path}\n")
    return map_path


def head_map(map_path, tmp_path, n):
    """A map of the first ``n`` lines of ``map_path``."""
    with open(map_path) as f:
        lines = f.readlines()[:n]
    out = str(tmp_path / f"map{n}.txt")
    with open(out, "w") as f:
        f.writelines(lines)
    return out


def test_signals_to_torch_feat_dir(wav_dir, tmp_path):
    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT], tmp_path, "f")
    assert runs["torch"][0] == runs["jax"][0] == 0
    got = load_dir(runs["torch"][1])
    assert len(got) == 20
    for feats in got.values():
        assert feats.ndim == 2 and feats.shape[1] == 10 and np.isfinite(feats).all()
    assert_dirs_close(runs["jax"][1], runs["torch"][1])


def test_signals_to_torch_feat_dir_matches_compute_full(wav_dir, tmp_path):
    from speech_tpu.alias import alias_factory_subclass_from_arg
    from speech_tpu.compute import FrameComputer
    from speech_tpu.io import read_signal

    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT], tmp_path, "f")
    computer = alias_factory_subclass_from_arg(FrameComputer, dict(COMPUTER))
    with open(wav_dir) as f:
        utt, path = f.readline().split()
    want = np.asarray(computer.compute_full(read_signal(path, dtype=np.float64)))
    got = torch.load(os.path.join(runs["torch"][1], utt + ".pt")).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_signals_to_torch_feat_dir_raw(wav_dir, tmp_path):
    runs = both("signals_to_torch_feat_dir", [wav_dir, OUT], tmp_path, "raw")
    assert runs["torch"][0] == runs["jax"][0] == 0
    want, got = load_dir(runs["jax"][1]), load_dir(runs["torch"][1])
    assert list(got) == list(want)
    for f in want:
        assert got[f].ndim == 2 and got[f].shape[1] == 1
        np.testing.assert_array_equal(got[f], want[f])


def test_signals_to_torch_feat_dir_deterministic(wav_dir, tmp_path):
    pre = json.dumps([{"name": "dither", "coeff": 0.1}])
    dirs = {}
    for workers in ("0", "4"):
        runs = both(
            "signals_to_torch_feat_dir",
            [wav_dir, CFG, OUT, "--preprocess", pre, "--seed", "5",
             "--num-workers", workers],
            tmp_path, f"w{workers}",
        )
        assert runs["torch"][0] == runs["jax"][0] == 0
        dirs[workers] = runs
    a, b = load_dir(dirs["0"]["torch"][1]), load_dir(dirs["4"]["torch"][1])
    assert list(a) == list(b)
    for f in a:
        assert np.array_equal(a[f], b[f]), f
    # the host dither draws the same numpy noise in both packages
    assert_dirs_close(dirs["0"]["jax"][1], dirs["0"]["torch"][1])


def test_signals_to_torch_feat_dir_manifest_resume(wav_dir, tmp_path):
    manifests = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        out = str(tmp_path / f"feats_{name}")
        manifest = str(tmp_path / f"manifest_{name}.txt")
        with open(manifest, "w") as f:
            f.write("utt00\nutt01\n")
        args = [wav_dir, json.dumps(_config(cli, COMPUTER)), out, "--manifest", manifest]
        assert cli.signals_to_torch_feat_dir(args) == 0
        files = sorted(os.listdir(out))
        assert len(files) == 18 and "utt00.pt" not in files and "utt02.pt" in files
        assert cli.signals_to_torch_feat_dir(args) == 0  # rerunning does nothing
        assert sorted(os.listdir(out)) == files
        with open(manifest) as f:
            manifests[name] = sorted(line.strip() for line in f if line.strip())
    assert manifests["torch"] == manifests["jax"] == [f"utt{i:02d}" for i in range(20)]
    assert_dirs_close(str(tmp_path / "feats_jax"), str(tmp_path / "feats_torch"))


def test_signals_to_torch_feat_dir_postprocess(wav_dir, tmp_path):
    post = json.dumps([{"name": "deltas", "num_deltas": 2}])
    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT, "--postprocess", post],
                tmp_path, "post")
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert next(iter(load_dir(runs["torch"][1]).values())).shape[1] == 30
    assert_dirs_close(runs["jax"][1], runs["torch"][1])


def test_cli_help_exits_zero(capsys):
    assert tcli.signals_to_torch_feat_dir(["--help"]) == 0
    assert "map" in capsys.readouterr().out
    assert tcli.torch_feat_dir_to_signals(["--help"]) == 0
    assert "Griffin-Lim" in capsys.readouterr().out


def test_kaldi_tables_graceful_without_dep(capsys):
    cfg = json.dumps(_config(tcli, COMPUTER))
    assert tcli.compute_feats_from_kaldi_tables(["scp:foo.scp", "ark:bar.ark", cfg]) == 1
    assert jcli.compute_feats_from_kaldi_tables(
        ["scp:foo.scp", "ark:bar.ark", json.dumps(COMPUTER)]) == 1
    capsys.readouterr()


def test_signals_to_torch_feat_dir_si_computer(wav_dir, tmp_path):
    si = {"name": "si", "bank": {"name": "fbank", "num_filts": 6, "sampling_rate": 8000},
          "frame_shift_ms": 10}
    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT], tmp_path, "si", si)
    assert runs["torch"][0] == runs["jax"][0] == 0
    got = load_dir(runs["torch"][1])
    assert len(got) == 20 and all(f.shape[1] == 6 for f in got.values())
    assert_dirs_close(runs["jax"][1], runs["torch"][1])


def test_profile_flag(wav_dir, tmp_path, capsys):
    trace_dir = str(tmp_path / "trace")
    for extra in ([], [trace_dir]):
        out = str(tmp_path / f"pf{len(extra)}")
        rc = tcli.signals_to_torch_feat_dir(
            [wav_dir, json.dumps(_config(tcli, COMPUTER)), out, "--profile", *extra])
        assert rc == 0
        err = capsys.readouterr().err
        # batched path stages: host read, queued dispatch, device wait/readback
        assert "stages" in err and "dispatch" in err and "collect" in err and "read" in err
        # the nested stages, and the extractor's count of its padding
        assert "pad: " in err and "wait: " in err and "useful share: " in err
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_config_type_yaml():
    pytest.importorskip("yaml")
    data_dir = os.path.join(os.path.dirname(__file__), "data")
    path = os.path.join(data_dir, "fbank.yaml")
    with open(os.path.join(data_dir, "fbank.json")) as f:
        want = json.load(f)
    assert tcli._config_type(path) == jcli._config_type(path) == want


def test_cli_accepts_yaml_computer_config(wav_dir, tmp_path):
    pytest.importorskip("yaml")
    body = ("name: stft\nbank: {name: fbank, num_filts: 6, sampling_rate: 8000}\n"
            "frame_length_ms: 25\nframe_shift_ms: 10\n")
    for name, cli, extra in (("jax", jcli, ""), ("torch", tcli, "device: cpu\n")):
        cfg = str(tmp_path / f"c_{name}.yaml")
        with open(cfg, "w") as f:
            f.write(body + extra)
        assert cli.signals_to_torch_feat_dir([wav_dir, cfg, str(tmp_path / name)]) == 0
    assert torch.load(str(tmp_path / "torch" / "utt00.pt")).shape[-1] == 6
    assert_dirs_close(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_compact_pcm_decision():
    exact = np.array([0.0, 1.0, -32768.0, 32767.0])
    cases = [exact, np.array([0.5]), np.array([40000.0]), np.array([-40000.0]),
             np.array([np.nan]), np.array([np.inf]), np.zeros(0)]
    assert tcli._compact_pcm(exact).dtype == np.int16
    for x in cases:
        got, want = tcli._compact_pcm(x), jcli._compact_pcm(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_load_utt_compact_downcast(wav_dir):
    with open(wav_dir) as f:
        utt, path = f.readline().split()
    item = (0, (utt, path))
    for compact in (True, False):
        got = tcli._load_utt(item, [], -1, None, None, compact=compact)
        want = jcli._load_utt(item, [], -1, None, None, compact=compact)
        assert got[0] == want[0] == utt
        assert got[1].dtype == want[1].dtype == (np.int16 if compact else np.float64)
        np.testing.assert_array_equal(got[1], want[1])


def test_load_utt_seeded_dither_matches_jax(wav_dir):
    """``_load_utt``'s per-utterance seeding: the port's host dither draws
    the JAX package's numpy noise, and leaves the global RNG as it was."""
    from speech_tpu.pre import Dither as JDither

    from speech_tpu_torch.pre import Dither

    with open(wav_dir) as f:
        utt, path = f.readlines()[3].split()
    state = np.random.get_state()
    got = tcli._load_utt((3, (utt, path)), [Dither(0.5)], -1, None, 11)[1]
    assert all(np.array_equal(a, b) for a, b in zip(np.random.get_state(), state))
    want = jcli._load_utt((3, (utt, path)), [JDither(0.5)], -1, None, 11)[1]
    np.testing.assert_array_equal(got, want)


def test_sort_window_invariant_outputs(wav_dir, tmp_path):
    outs = {}
    for win in ("1", "4"):
        out = str(tmp_path / f"sw{win}")
        assert tcli.signals_to_torch_feat_dir(
            [wav_dir, json.dumps(_config(tcli, COMPUTER)), out, "--batch-size", "4",
             "--sort-window", win]) == 0
        outs[win] = load_dir(out)
    assert outs["1"].keys() == outs["4"].keys()
    for f in outs["1"]:
        assert np.array_equal(outs["1"][f], outs["4"][f]), f
    jax_out = str(tmp_path / "sw_jax")
    assert jcli.signals_to_torch_feat_dir(
        [wav_dir, json.dumps(COMPUTER), jax_out, "--batch-size", "4", "--sort-window", "4"]) == 0
    assert_dirs_close(jax_out, str(tmp_path / "sw4"))


def test_signals_resample_from(wav_dir, tmp_path):
    cfg = json.loads(json.dumps(COMPUTER))
    cfg["bank"]["sampling_rate"] = 16000
    runs = both("signals_to_torch_feat_dir",
                [wav_dir, CFG, OUT, "--resample-from", "8000", "--batch-size", "4"],
                tmp_path, "rs", cfg)
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert_dirs_close(runs["jax"][1], runs["torch"][1])


def test_signals_resample_from_requires_computer(wav_dir, tmp_path, capsys):
    runs = both("signals_to_torch_feat_dir", [wav_dir, OUT, "--resample-from", "8000"],
                tmp_path, "rs2")
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("computer config") == 2


def test_signals_resample_from_zero_rejected(wav_dir, tmp_path, capsys):
    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT, "--resample-from", "0"],
                tmp_path, "rs0")
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("positive") == 2


def test_speed_perturb_outputs(wav_dir, tmp_path):
    runs = both("signals_to_torch_feat_dir",
                [wav_dir, CFG, OUT, "--speed-perturb", "0.9,1.0,1.1", "--batch-size", "4"],
                tmp_path, "sp")
    assert runs["torch"][0] == runs["jax"][0] == 0
    files = sorted(os.listdir(runs["torch"][1]))
    assert len(files) == 60
    assert sum(f.startswith("sp0.9-") for f in files) == 20
    assert sum(f.startswith("sp1.1-") for f in files) == 20
    assert_dirs_close(runs["jax"][1], runs["torch"][1])
    plain = str(tmp_path / "plain")
    assert tcli.signals_to_torch_feat_dir(
        [wav_dir, json.dumps(_config(tcli, COMPUTER)), plain, "--batch-size", "4"]) == 0
    for f in files[:4]:
        if not f.startswith("sp"):
            assert torch.equal(torch.load(os.path.join(plain, f)),
                               torch.load(os.path.join(runs["torch"][1], f))), f


def test_speed_perturb_bad_factor(wav_dir, tmp_path, capsys):
    runs = both("signals_to_torch_feat_dir",
                [wav_dir, CFG, OUT, "--speed-perturb", "0.9,-1"], tmp_path, "spb")
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("positive") == 2


def test_speed_perturb_manifest_resume(wav_dir, tmp_path):
    out = str(tmp_path / "feats_sp_m")
    manifest = str(tmp_path / "sp_manifest.txt")
    args = [wav_dir, json.dumps(_config(tcli, COMPUTER)), out, "--speed-perturb",
            "0.9,1.1", "--manifest", manifest, "--batch-size", "4"]
    assert tcli.signals_to_torch_feat_dir(args) == 0
    with open(manifest) as f:
        done = set(line.strip() for line in f)
    assert len(done) == 40
    before = {f: os.path.getmtime(os.path.join(out, f)) for f in os.listdir(out)}
    assert tcli.signals_to_torch_feat_dir(args) == 0
    assert before == {f: os.path.getmtime(os.path.join(out, f)) for f in os.listdir(out)}
    jax_manifest = str(tmp_path / "sp_manifest_jax.txt")
    assert jcli.signals_to_torch_feat_dir(
        [wav_dir, json.dumps(COMPUTER), str(tmp_path / "feats_sp_j"), "--speed-perturb",
         "0.9,1.1", "--manifest", jax_manifest, "--batch-size", "4"]) == 0
    with open(jax_manifest) as f:
        assert set(line.strip() for line in f) == done


def test_vad_trim_outputs(wav_dir, tmp_path):
    cfg = dict(COMPUTER, include_energy=True)
    post = json.dumps([{"name": "standardize"}])
    runs = both("signals_to_torch_feat_dir",
                [wav_dir, CFG, OUT, "--vad-trim", '{"frames_context": 2}', "--postprocess",
                 post, "--batch-size", "4"], tmp_path, "vad", cfg)
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert_dirs_close(runs["jax"][1], runs["torch"][1])
    # some rows were trimmed: fewer than the untrimmed frame counts
    from speech_tpu_torch.compute import STFTFrameComputer

    full = STFTFrameComputer(cfg["bank"], frame_length_ms=25, device="cpu")
    got = load_dir(runs["torch"][1])
    sizes = {}
    with open(wav_dir) as f:
        for line in f:
            utt, path = line.split()
            with wave.open(path) as w:
                sizes[utt] = w.getnframes()
    assert any(
        got[u + ".pt"].shape[0] < (n + full.frame_shift // 2) // full.frame_shift
        for u, n in sizes.items()
    )


def test_vad_trim_requires_energy(wav_dir, tmp_path, capsys):
    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT, "--vad-trim", "{}"],
                tmp_path, "v1")
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("include_energy") == 2


def test_vad_trim_requires_computer(wav_dir, tmp_path, capsys):
    runs = both("signals_to_torch_feat_dir", [wav_dir, OUT, "--vad-trim", "{}"], tmp_path, "v2")
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("computer config") == 2


def test_vad_trim_bad_key_rejected(wav_dir, tmp_path, capsys):
    runs = both("signals_to_torch_feat_dir",
                [wav_dir, CFG, OUT, "--vad-trim", '{"not_a_knob": 1}'], tmp_path, "v3",
                dict(COMPUTER, include_energy=True))
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("--vad-trim") == 2


def test_vad_trim_frame_count_change_rejected(wav_dir, tmp_path):
    cfg = dict(COMPUTER, include_energy=True, device="cpu")
    post = json.dumps([{"name": "stack", "num_vectors": 3}])
    with pytest.raises(ValueError, match="frame count"):
        tcli.signals_to_torch_feat_dir(
            [wav_dir, json.dumps(cfg), str(tmp_path / "v4"), "--vad-trim", "{}",
             "--postprocess", post, "--batch-size", "4"])


def test_signals_to_torch_feat_dir_pitch(wav_dir, tmp_path):
    """--pitch on the port's batched and host paths against the JAX CLI's
    host path (one pitch program: every signal fits the 8192 bucket) on
    four utterances."""
    small = head_map(wav_dir, tmp_path, 4)
    jax_out = str(tmp_path / "pitch_jax")
    assert jcli.signals_to_torch_feat_dir(
        [small, json.dumps(COMPUTER), jax_out, "--pitch", "{}", "--batch-size", "0"]) == 0
    cfg = json.dumps(_config(tcli, COMPUTER))
    for tag, batch in (("b", "4"), ("h", "0")):
        out = str(tmp_path / f"pitch_{tag}")
        assert tcli.signals_to_torch_feat_dir(
            [small, cfg, out, "--pitch", "{}", "--batch-size", batch]) == 0
        want, got = load_dir(jax_out), load_dir(out)
        assert list(got) == list(want) and len(got) == 4
        for f in want:
            assert got[f].shape == want[f].shape and got[f].shape[1] == 13, f
            np.testing.assert_allclose(got[f][:, :10], want[f][:, :10], rtol=0, atol=TOL)
            np.testing.assert_allclose(got[f][:, 10:], want[f][:, 10:], rtol=0, atol=TOL_PITCH)


STACK = json.dumps([{"name": "stack", "num_vectors": 3}])
PASTE_WARNING = "--pitch pastes row-for-row"


def _short_map(wav_dir, tmp_path):
    """The first three utterances and three shorter than one tracker frame
    (375 samples at 8 kHz): in batches of 2 the two shortest share a
    bucket the tracker never runs on, the third rides beside a tracked
    row."""
    rng = np.random.RandomState(51)
    out = str(tmp_path / "short_map.txt")
    with open(wav_dir) as f, open(out, "w") as mf:
        mf.writelines(f.readlines()[:3])
        for n in (210, 240, 300):
            path = str(tmp_path / f"short{n}.wav")
            write_wav(path, (rng.randn(n) * 1000).astype(np.int16), 8000)
            mf.write(f"short{n} {path}\n")
    return out


@pytest.mark.parametrize("case", ["short", "stack"])
def test_signals_to_torch_feat_dir_pitch_cases(case, wav_dir, tmp_path, caplog):
    """--pitch on the port's batched and host paths against the JAX CLI:
    utterances too short to track get zero columns; after a stack the
    columns are pasted to the stacked rows, with one warning a run."""
    if case == "short":
        small, extra, width = _short_map(wav_dir, tmp_path), [], 13
    else:
        small, extra, width = head_map(wav_dir, tmp_path, 4), ["--postprocess", STACK], 33
    jax_out = str(tmp_path / "pitch_jax")
    assert jcli.signals_to_torch_feat_dir(
        [small, json.dumps(COMPUTER), jax_out, "--pitch", "{}", "--batch-size", "0",
         *extra]) == 0
    want = load_dir(jax_out)
    cfg = json.dumps(_config(tcli, COMPUTER))
    for batch in ("2", "0"):
        caplog.clear()
        out = str(tmp_path / f"pitch_{batch}")
        with caplog.at_level("WARNING", logger=tcli.logger.name):
            assert tcli.signals_to_torch_feat_dir(
                [small, cfg, out, "--pitch", "{}", "--batch-size", batch, *extra]) == 0
        warned = [r for r in caplog.records
                  if r.name == tcli.logger.name and PASTE_WARNING in r.getMessage()]
        assert len(warned) == (case == "stack"), batch
        got = load_dir(out)
        assert list(got) == list(want) and len(got) == (6 if case == "short" else 4)
        for f in want:
            assert got[f].shape == want[f].shape and got[f].shape[1] == width, f
            if f.startswith("short"):
                assert got[f].shape[0] and not got[f][:, -3:].any(), f
            np.testing.assert_allclose(got[f][:, :-3], want[f][:, :-3], rtol=0, atol=TOL)
            np.testing.assert_allclose(got[f][:, -3:], want[f][:, -3:], rtol=0,
                                       atol=TOL_PITCH)


def test_batched_pitch_runs_in_the_extractor(wav_dir, tmp_path, monkeypatch):
    """A batched --pitch run tracks each batch once, from
    ``ShardedExtractor``'s own pitch step, and never through
    ``sharded_pitch_feats``."""
    import speech_tpu_torch.parallel as tpar
    import speech_tpu_torch.parallel.extract as textract
    from speech_tpu_torch.ops import pitch as tpitch

    callers = []
    real = tpitch.pitch_feats

    def spy(*args, **kwargs):
        frame = sys._getframe(1)
        callers.append((os.path.basename(frame.f_code.co_filename), frame.f_code.co_name))
        return real(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("sharded_pitch_feats called")

    monkeypatch.setattr(tpitch, "pitch_feats", spy)
    monkeypatch.setattr(tpar, "sharded_pitch_feats", refuse)
    monkeypatch.setattr(textract, "sharded_pitch_feats", refuse)
    small = head_map(wav_dir, tmp_path, 4)
    cfg = json.dumps(_config(tcli, COMPUTER))
    assert tcli.signals_to_torch_feat_dir(
        [small, cfg, str(tmp_path / "spy"), "--pitch", "{}", "--batch-size", "2"]) == 0
    assert callers == [("extract.py", "_with_pitch")] * 2


def test_pitch_requires_computer(wav_dir, tmp_path):
    runs = both("signals_to_torch_feat_dir", [wav_dir, OUT, "--pitch", "{}"], tmp_path, "p1")
    assert runs["torch"][0] == runs["jax"][0] == 1
    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT, "--pitch", "[1]"], tmp_path,
                "p2")
    assert runs["torch"][0] == runs["jax"][0] == 1


def _extract_20(wav_dir, tmp_path):
    """Both packages' features of the 20 wavs with 20 filters: the
    (jax dir, port dir, config)."""
    cfg = json.loads(json.dumps(COMPUTER))
    cfg["bank"]["num_filts"] = 20
    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT, "--batch-size", "4"],
                tmp_path, "inv", cfg)
    assert runs["torch"][0] == runs["jax"][0] == 0
    return runs["jax"][1], runs["torch"][1], cfg


def test_torch_feat_dir_to_signals_roundtrip(wav_dir, tmp_path):
    """Extract -> invert -> wavs whose re-analysis recovers the features;
    the JAX command on the same features writes the same files.  (At 8
    float32 Griffin-Lim iterations the two packages' samples drift apart
    by a few LSB; test_feat_dirs_cross_packages holds them at 4.)"""
    from speech_tpu_torch.compute import STFTFrameComputer
    from speech_tpu_torch.io import read_signal

    jax_feats, feat_dir, cfg = _extract_20(wav_dir, tmp_path)
    assert_dirs_close(jax_feats, feat_dir)
    args = ["--n-iters", "8", "--batch-size", "4"]
    wav_out = str(tmp_path / "wavs_inv")
    assert tcli.torch_feat_dir_to_signals(
        [feat_dir, json.dumps(_config(tcli, cfg)), wav_out, *args]) == 0
    files = sorted(os.listdir(wav_out))
    assert len(files) == 20 and all(f.endswith(".wav") for f in files)
    jax_out = str(tmp_path / "wavs_inv_jax")
    assert jcli.torch_feat_dir_to_signals([feat_dir, json.dumps(cfg), jax_out, *args]) == 0
    assert sorted(os.listdir(jax_out)) == files
    for f in files:
        assert read_wav(os.path.join(jax_out, f))[1].shape == read_wav(
            os.path.join(wav_out, f))[1].shape, f
    computer = STFTFrameComputer(cfg["bank"], frame_length_ms=25, device="cpu")
    worst = 0.0
    for f in files[:4]:
        rate, _ = read_wav(os.path.join(wav_out, f))
        assert rate == 8000
        want = torch.load(os.path.join(feat_dir, f[:-4] + ".pt")).numpy()
        y = read_signal(os.path.join(wav_out, f), dtype=np.float64)
        assert len(y) == want.shape[0] * computer.frame_shift
        got = np.asarray(computer.compute_full(y))[: want.shape[0]]
        worst = max(worst, float(np.mean((got - want) ** 2) / np.var(want)))
    assert worst < 0.2, worst


def test_feat_dirs_cross_packages(wav_dir, tmp_path):
    """The port's .pt files invert through the JAX command as the JAX
    files do, and the JAX files through the port's."""
    jax_feats, port_feats, cfg = _extract_20(wav_dir, tmp_path)
    args = ["--n-iters", "4", "--batch-size", "8"]
    outs = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        for src, feats in (("jax", jax_feats), ("torch", port_feats)):
            out = str(tmp_path / f"x_{name}_{src}")
            assert cli.torch_feat_dir_to_signals(
                [feats, json.dumps(_config(cli, cfg)), out, *args]) == 0
            outs[name, src] = out
    assert_wav_dirs_close(outs["jax", "jax"], outs["jax", "torch"])
    assert_wav_dirs_close(outs["torch", "torch"], outs["torch", "jax"])
    assert_wav_dirs_close(outs["jax", "jax"], outs["torch", "torch"])


def test_torch_feat_dir_to_signals_validation(tmp_path, capsys):
    si_cfg = {"name": "si", "bank": {"name": "fbank", "num_filts": 4, "sampling_rate": 8000}}
    runs = both("torch_feat_dir_to_signals", [str(tmp_path), CFG, OUT], tmp_path, "w", si_cfg)
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("STFT") == 2
    runs = both("torch_feat_dir_to_signals", [str(tmp_path), CFG, OUT], tmp_path, "w")
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("no '*.pt' files") == 2


def test_torch_feat_dir_to_signals_skips_bad_files(tmp_path, capsys):
    feat_dir = tmp_path / "feats_mixed"
    feat_dir.mkdir()
    rng = np.random.RandomState(4)
    torch.save(torch.as_tensor(rng.randn(50, 10).astype(np.float32)), feat_dir / "good.pt")
    torch.save(torch.as_tensor(rng.randn(50, 7).astype(np.float32)), feat_dir / "badwidth.pt")
    runs = both("torch_feat_dir_to_signals",
                [str(feat_dir), CFG, OUT, "--n-iters", "2", "--peak-norm", "0.9"],
                tmp_path, "mixed")
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert capsys.readouterr().err.count("badwidth") == 2
    assert sorted(os.listdir(runs["torch"][1])) == ["good.wav"]
    _, pcm = read_wav(os.path.join(runs["torch"][1], "good.wav"))
    assert np.abs(pcm).max() <= int(0.9 * 32767) + 1
    assert sorted(os.listdir(runs["jax"][1])) == ["good.wav"]


# --- --learned-params (tests/test_nn_export.py:181-262) ---------------------


def _perturbed(params):
    rng = np.random.RandomState(0)
    return {k: np.asarray(v) * (1 + 0.2 * rng.rand(*np.shape(v))) for k, v in params.items()}


def test_cli_learned_params_runs_trained_frontend(wav_dir, tmp_path):
    from speech_tpu.alias import alias_factory_subclass_from_arg
    from speech_tpu.compute import FrameComputer
    from speech_tpu.nn import STFTFrontend

    small = head_map(wav_dir, tmp_path, 3)
    cfg = dict(COMPUTER, bank=dict(COMPUTER["bank"], num_filts=8))
    frontend = STFTFrontend(alias_factory_subclass_from_arg(FrameComputer, cfg))
    params, _ = frontend.init()
    ckpt = str(tmp_path / "frontend.npz")
    frontend.save_params(ckpt, _perturbed(params))
    runs = both("signals_to_torch_feat_dir", [small, CFG, OUT, "--learned-params", ckpt],
                tmp_path, "lp", cfg)
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert_dirs_close(runs["jax"][1], runs["torch"][1])
    plain = str(tmp_path / "lp_plain")
    assert tcli.signals_to_torch_feat_dir([small, json.dumps(_config(tcli, cfg)), plain]) == 0
    a, b = load_dir(plain), load_dir(runs["torch"][1])
    assert max(np.abs(a[f] - b[f]).max() for f in a) > 1e-3  # the checkpoint did change them


def test_cli_learned_params_accepts_kws_checkpoint(wav_dir, tmp_path):
    import jax

    from speech_tpu.alias import alias_factory_subclass_from_arg
    from speech_tpu.compute import FrameComputer
    from speech_tpu.models.kws import KWSModel, save_params
    from speech_tpu.nn import STFTFrontend

    small = head_map(wav_dir, tmp_path, 3)
    cfg = dict(COMPUTER, bank=dict(COMPUTER["bank"], num_filts=8))
    model = KWSModel(STFTFrontend(alias_factory_subclass_from_arg(FrameComputer, cfg)),
                     num_classes=2, channels=(8,))
    params, _ = model.init(jax.random.PRNGKey(0))
    params = dict(params, frontend=_perturbed(params["frontend"]))
    ckpt = str(tmp_path / "kws.npz")
    save_params(ckpt, params)
    runs = both("signals_to_torch_feat_dir", [small, CFG, OUT, "--learned-params", ckpt],
                tmp_path, "kws", cfg)
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert len(os.listdir(runs["torch"][1])) == 3
    assert_dirs_close(runs["jax"][1], runs["torch"][1])


def test_cli_learned_params_rejects_si_config(wav_dir, tmp_path, capsys):
    ckpt = str(tmp_path / "x.npz")
    np.savez(ckpt, window=np.zeros(3), weights=np.zeros((3, 3)))
    si = {"name": "si", "bank": {"name": "gammatone", "scaling_function": "mel",
                                 "num_filts": 4, "sampling_rate": 8000}}
    runs = both("signals_to_torch_feat_dir", [wav_dir, CFG, OUT, "--learned-params", ckpt],
                tmp_path, "lpsi", si)
    assert runs["torch"][0] == runs["jax"][0] == 1
    assert capsys.readouterr().err.count("STFT computer") == 2


# --- a preset name as the config (tests/test_presets.py:35) -----------------


def test_cli_accepts_preset_name(tmp_path):
    rng = np.random.RandomState(5)
    wav = str(tmp_path / "u.wav")
    write_wav(wav, (rng.randn(8000) * 1000).astype(np.int16), 16000)
    mp = str(tmp_path / "map.txt")
    with open(mp, "w") as f:
        f.write(f"u {wav}\n")
    preset = tcli._config_type("fbank-80-16k")
    assert preset == jcli._config_type("fbank-80-16k")
    assert jcli.signals_to_torch_feat_dir([mp, "fbank-80-16k", str(tmp_path / "j")]) == 0
    # a preset carries no device, so the port's computer runs on the GPU
    if torch.cuda.is_available():
        assert tcli.signals_to_torch_feat_dir([mp, "fbank-80-16k", str(tmp_path / "c")]) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.signals_to_torch_feat_dir([mp, "fbank-80-16k", str(tmp_path / "c")])
    assert tcli.signals_to_torch_feat_dir(
        [mp, json.dumps(dict(preset, device="cpu")), str(tmp_path / "t")]) == 0
    assert torch.load(str(tmp_path / "t" / "u.pt")).shape[1] == 80
    assert_dirs_close(str(tmp_path / "j"), str(tmp_path / "t"))


# --- the port's own contracts ----------------------------------------------


class _Parsed(Exception):
    pass


def _parser_of(parse, monkeypatch):
    """The ArgumentParser that ``parse`` builds (caught at parse_args)."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            parse([])
    return seen[0]


def _options(parser):
    return sorted(
        (tuple(a.option_strings) or (a.dest,), a.nargs, a.const, a.default,
         tuple(sorted(a.choices)) if a.choices else None)
        for a in parser._actions
    )


@pytest.mark.parametrize("parse", [
    "_signals_to_torch_feat_dir_parse_args",
    "_compute_feats_from_kaldi_tables_parse_args",
    "_torch_feat_dir_to_signals_parse_args",
    "_copy_feats_tables_parse_args",
])
def test_parsers_take_the_reference_options(parse, monkeypatch):
    want = _options(_parser_of(getattr(jcli, parse), monkeypatch))
    got = _options(_parser_of(getattr(tcli, parse), monkeypatch))
    assert got == want


def test_main_dispatches_every_command(wav_dir, tmp_path):
    cfg = json.dumps(_config(tcli, COMPUTER))
    feats = str(tmp_path / "feats")
    assert tcli.main(["signals-to-torch-feat-dir", wav_dir, cfg, feats]) == 0
    assert tcli.main(["copy-feats-tables", "dir:" + feats, "ark:" + str(tmp_path / "f.ark")]) == 0
    assert tcli.main(["compute-feats-from-kaldi-tables", "scp:" + wav_dir,
                      "ark:" + str(tmp_path / "g.ark"), cfg]) == 0
    from speech_tpu_torch.io.kaldi_tables import iter_table

    copied = dict(iter_table("ark:" + str(tmp_path / "f.ark")))
    computed = dict(iter_table("ark:" + str(tmp_path / "g.ark")))
    assert sorted(copied) == sorted(computed)
    for u in copied:  # the same batched route from two ingress paths
        np.testing.assert_array_equal(copied[u], computed[u])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "speech_tpu_torch.command_line", "torch-feat-dir-to-signals",
         feats, cfg, str(tmp_path / "w"), "--n-iters", "1"],
        env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    assert len(os.listdir(tmp_path / "w")) == 20
    assert "jax" not in proc.stderr


def test_stage_timer_and_trace(tmp_path):
    from speech_tpu.profiling import StageTimer as JStageTimer

    from speech_tpu_torch.profiling import StageTimer, trace

    for timer in (StageTimer(), JStageTimer()):
        for name in ("read", "write", "read"):
            with timer.stage(name):
                pass
        assert set(timer.totals) == {"read", "write"}
        assert timer.summary().startswith("stages (") and "read: " in timer.summary()
        assert "/2x" in timer.summary()
    with trace(None):
        pass
    with pytest.raises(KeyError):  # the body's own exception propagates
        with trace(str(tmp_path / "t")):
            torch.ones(3).sum()
            raise KeyError("body")
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")


def test_world_size_2_rank_0_writes(wav_dir, tmp_path):
    """signals-to-torch-feat-dir on a two-process gloo group: each batch
    splits over the "data" mesh, every rank gathers every row, rank 0
    alone writes, and its files equal world size 1's."""
    procs, out = W.launch(2, str(tmp_path), "cli")
    single = str(tmp_path / "world1")
    cfg = json.dumps(dict(COMPUTER, dtype="float64", device="cpu"))
    rc = tcli.signals_to_torch_feat_dir(
        [W.write_cli_corpus(str(tmp_path / "corpus1")), cfg, single, "--batch-size", "4"])
    assert rc == 0
    r = W.wait(procs, out)
    assert r["rcs"].tolist() == [0, 0]
    assert r["others_wrote"] == 0  # rank 1 wrote no file and no manifest line
    want = load_dir(single)
    assert r["names"].tolist() == list(want)
    got = np.split(r["feats"], np.cumsum(r["frames"])[:-1])
    for f, g in zip(want, got):
        np.testing.assert_allclose(g, want[f], rtol=0, atol=1e-8)
