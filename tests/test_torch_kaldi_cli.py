"""The port's Kaldi-table CLIs against the JAX CLIs, on the CPU.

Twins of ``tests/test_kaldi_tables.py`` (``compute-feats-from-kaldi-tables``
through a fake ``pydrobert.kaldi.io``: the fixture below is a copy of that
file's) and of the CLI cases of ``tests/test_kaldi_native.py`` (the native
table I/O: ``--compress``, ``--segments``, ``copy-feats-tables``, wav.scp
pipes).  Both packages run on the same tables: the JAX config as it is, the
port's plus ``"device": "cpu"``.  Features within 1e-4 (the float tier,
``tests/test_pallas.py:55``; a ``--seed`` dither draws the same numpy
noise), pitch columns within 2e-3 (the reference CLI's tolerance), copied
tables bitwise; table keys, their order and return codes equal.
"""

import functools
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import speech_tpu.command_line as jcli

import speech_tpu_torch.command_line as tcli
from speech_tpu_torch.io import kaldi_tables as kt

TOL = 1e-4
TOL_PITCH = 2e-3
COMPUTER_CONFIG = {
    "name": "stft",
    "bank": {"name": "fbank", "num_filts": 10, "sampling_rate": 8000},
    "frame_length_ms": 25,
    "frame_shift_ms": 10,
}


def _no_bindings():
    try:
        import pydrobert.kaldi.io  # noqa: F401

        return False
    except ImportError:
        return True


def _config(cli, cfg=COMPUTER_CONFIG):
    return json.dumps(cfg if cli is jcli else dict(cfg, device="cpu"))


def _close(got, want, tol=TOL):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


# --- the fake bindings (tests/test_kaldi_tables.py) ----------------------


class _FakeReader:
    """Lazily decoding reader; counts entries handed out so tests can
    assert the CLI streams the table instead of materializing it."""

    def __init__(self, table, decoded):
        self._table = table
        self._decoded = decoded

    def items(self):
        for key, value in self._table.items():
            self._decoded.append(key)
            yield key, value

    def __getitem__(self, key):
        self._decoded.append(key)
        return self._table[key]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


class _FakeWriter:
    def __init__(self, store, decoded=None):
        self._store = store
        self._decoded = decoded
        self.decoded_at_first_write = None

    def write(self, key, value):
        if self.decoded_at_first_write is None and self._decoded is not None:
            self.decoded_at_first_write = len(self._decoded)
        self._store[key] = np.asarray(value)

    def close(self):
        pass


def _install_fake(monkeypatch):
    tables = {}
    written = {}
    decoded = []
    writers = []

    def kaldi_open(specifier, dtype=None, mode="r", value_style=None):
        if dtype is not None and dtype not in ("b", "bm", "bv", "dm", "fm", "wm"):
            raise TypeError(f"unknown kaldi dtype: {dtype!r}")
        if mode == "w":
            written.setdefault(specifier, {})
            writer = _FakeWriter(written[specifier], decoded)
            writers.append(writer)
            return writer
        if specifier not in tables:
            raise IOError(f"no such table: {specifier}")
        return _FakeReader(tables[specifier], decoded)

    io_mod = types.ModuleType("pydrobert.kaldi.io")
    io_mod.open = kaldi_open
    enums_mod = types.ModuleType("pydrobert.kaldi.io.enums")

    class _BaseMatrix:
        is_double = False

    class KaldiDataType:
        BaseMatrix = _BaseMatrix

    enums_mod.KaldiDataType = KaldiDataType
    io_mod.enums = enums_mod
    kaldi_mod = types.ModuleType("pydrobert.kaldi")
    kaldi_mod.io = io_mod
    pydrobert_mod = types.ModuleType("pydrobert")
    pydrobert_mod.kaldi = kaldi_mod
    for name, mod in (
        ("pydrobert", pydrobert_mod),
        ("pydrobert.kaldi", kaldi_mod),
        ("pydrobert.kaldi.io", io_mod),
        ("pydrobert.kaldi.io.enums", enums_mod),
    ):
        monkeypatch.setitem(sys.modules, name, mod)
    return types.SimpleNamespace(
        tables=tables, written=written, decoded=decoded, writers=writers
    )


@pytest.fixture
def fake_kaldi(monkeypatch):
    """Inject a fake pydrobert.kaldi.io unless the real one exists."""
    if not _no_bindings():
        pytest.skip("real pydrobert-kaldi present; shim unnecessary")
    return _install_fake(monkeypatch)


def _wave_entry(rng, seconds=0.5, rate=8000, channels=1):
    n = int(seconds * rate)
    buff = (rng.randn(channels, n) * 1000).astype(np.float64)
    return buff, float(rate), float(seconds)


def _both(fake, rspec, tag, *extra, cfg=COMPUTER_CONFIG):
    """The port's command, then the JAX one, on ``rspec`` into
    ``ark:<tag>_<package>.ark``: their (rc, written table)."""
    out = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        spec = f"ark:{tag}_{name}.ark"
        rc = cli.compute_feats_from_kaldi_tables([rspec, spec, _config(cli, cfg), *extra])
        out[name] = (rc, fake.written.get(spec, {}))
    return out


def test_kaldi_tables_round_trip(fake_kaldi):
    rng = np.random.RandomState(17)
    fake_kaldi.tables["ark:wav.ark"] = {"utt1": _wave_entry(rng),
                                        "utt2": _wave_entry(rng, seconds=0.9)}
    runs = _both(fake_kaldi, "ark:wav.ark", "feats")
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert set(runs["torch"][1]) == {"utt1", "utt2"}
    assert runs["torch"][1]["utt1"].dtype == np.float32
    _close(runs["torch"][1], runs["jax"][1])


def test_kaldi_tables_skips_and_failures(fake_kaldi):
    rng = np.random.RandomState(18)
    good = _wave_entry(rng)
    fake_kaldi.tables["ark:wav.ark"] = {
        "ok": good,
        "too_short": _wave_entry(rng, seconds=0.05),
        "bad_rate": (good[0], 16000.0, good[2]),
        "multichan": _wave_entry(rng, channels=2),
        "bad_chan": _wave_entry(rng, channels=1),
    }
    runs = _both(fake_kaldi, "ark:wav.ark", "feats", "--min-duration", "0.2")
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert set(runs["torch"][1]) == {"ok", "multichan", "bad_chan"}
    _close(runs["torch"][1], runs["jax"][1])
    for cli in (tcli, jcli):
        assert cli.compute_feats_from_kaldi_tables(["ark:absent", "ark:o", _config(cli)]) == 1
    fake_kaldi.tables["ark:mono.ark"] = {"m": _wave_entry(rng)}
    runs = _both(fake_kaldi, "ark:mono.ark", "o2", "--channel", "3")
    assert runs["torch"][0] == runs["jax"][0] == 1


def test_kaldi_tables_corpus_scale_lazy_and_batched(fake_kaldi):
    rng = np.random.RandomState(20)
    table = {f"utt{i:03d}": _wave_entry(rng, seconds=float(rng.uniform(0.3, 0.5)))
             for i in range(200)}
    fake_kaldi.tables["ark:big.ark"] = table
    runs = _both(fake_kaldi, "ark:big.ark", "big", "--batch-size", "16")
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert list(runs["torch"][1]) == list(table)  # all utterances, in table order
    # the port ran first: at its first write at most ~2 batches (the
    # dispatch lookahead) of the 200 entries had been decoded
    first = fake_kaldi.writers[0].decoded_at_first_write
    assert first is not None and first <= 3 * 16, first
    _close(runs["torch"][1], runs["jax"][1])


def test_kaldi_tables_batch_disabled_matches(fake_kaldi):
    rng = np.random.RandomState(21)
    fake_kaldi.tables["ark:wav.ark"] = {"a": _wave_entry(rng),
                                        "b": _wave_entry(rng, seconds=0.7)}
    host = _both(fake_kaldi, "ark:wav.ark", "x", "--batch-size", "0")
    batched = _both(fake_kaldi, "ark:wav.ark", "y")
    for runs in (host, batched):
        assert runs["torch"][0] == runs["jax"][0] == 0
        _close(runs["torch"][1], runs["jax"][1])
    _close(host["torch"][1], batched["torch"][1], tol=1e-5)


def test_standardize_stats_load_from_kaldi_table(fake_kaldi):
    """The port's Standardize loads statistics from a Kaldi table through
    the bindings' 'dm'/'fm' fallbacks, as the JAX package's does."""
    from speech_tpu.post import Standardize as JStandardize

    from speech_tpu_torch.post import Standardize

    rng = np.random.RandomState(22)
    feats = rng.randn(30, 8)
    ref = Standardize()
    ref.accumulate(feats)
    fake_kaldi.tables["ark:stats.ark"] = {"global": np.asarray(ref.stats)}
    got = Standardize("ark:stats.ark", key="global").apply(feats)
    np.testing.assert_allclose(got, ref.apply(feats))
    np.testing.assert_allclose(got, JStandardize("ark:stats.ark", key="global").apply(feats),
                               rtol=0, atol=1e-12)


def test_kaldi_tables_preprocess_seed_determinism(fake_kaldi):
    pre = '[{"name": "dither"}]'
    outs = {}
    for tag in ("a", "b"):
        for name, cli in (("torch", tcli), ("jax", jcli)):
            # dither mutates in place: a fresh source for every run
            fake_kaldi.tables["ark:wav.ark"] = {"u": _wave_entry(np.random.RandomState(19))}
            spec = f"ark:{tag}_{name}.ark"
            assert cli.compute_feats_from_kaldi_tables(
                ["ark:wav.ark", spec, _config(cli), "--preprocess", pre, "--seed", "7"]) == 0
            outs[tag, name] = fake_kaldi.written[spec]["u"].copy()
    assert np.array_equal(outs["a", "torch"], outs["b", "torch"])
    np.testing.assert_allclose(outs["a", "torch"], outs["a", "jax"], rtol=0, atol=TOL)


def test_kaldi_tables_sort_window_preserves_table_order(fake_kaldi):
    rng = np.random.RandomState(23)
    table = {f"utt{i:03d}": _wave_entry(rng, seconds=float(rng.uniform(0.3, 1.1)))
             for i in range(96)}
    fake_kaldi.tables["ark:mixed.ark"] = table
    runs = _both(fake_kaldi, "ark:mixed.ark", "sorted", "--batch-size", "8",
                 "--sort-window", "3")
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert list(runs["torch"][1]) == list(table)  # exact table order despite sorting
    first = fake_kaldi.writers[0].decoded_at_first_write
    assert first is not None and first <= (2 * 3 + 2) * 8, first
    _close(runs["torch"][1], runs["jax"][1])


def test_kaldi_tables_fine_buckets(fake_kaldi):
    rng = np.random.RandomState(24)
    fake_kaldi.tables["ark:wav.ark"] = {"a": _wave_entry(rng, seconds=0.62),
                                        "b": _wave_entry(rng, seconds=0.9)}
    runs = _both(fake_kaldi, "ark:wav.ark", "f", "--fine-buckets")
    assert runs["torch"][0] == runs["jax"][0] == 0
    _close(runs["torch"][1], runs["jax"][1])


def test_kaldi_tables_resample_flag(fake_kaldi):
    rng = np.random.RandomState(23)
    fake_kaldi.tables["ark:wav.ark"] = {"ok": _wave_entry(rng),
                                        "fast": _wave_entry(rng, rate=16000)}
    runs = _both(fake_kaldi, "ark:wav.ark", "skip")
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert set(runs["torch"][1]) == set(runs["jax"][1]) == {"ok"}
    runs = _both(fake_kaldi, "ark:wav.ark", "rs", "--resample", "--batch-size", "2")
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert set(runs["torch"][1]) == {"ok", "fast"}
    _close(runs["torch"][1], runs["jax"][1])


def _pitch_table():
    rng = np.random.RandomState(23)
    return {f"utt{i}": _wave_entry(rng, seconds=0.5 + 0.2 * i) for i in range(4)}


@functools.lru_cache(maxsize=None)
def _jax_pitch_output():
    """The JAX command's --pitch output on :func:`_pitch_table` (its host
    path: one pitch program per signal bucket), computed once."""
    with pytest.MonkeyPatch.context() as mp:
        fake = _install_fake(mp)
        fake.tables["ark:wav.ark"] = _pitch_table()
        rc = jcli.compute_feats_from_kaldi_tables(
            ["ark:wav.ark", "ark:feats.ark", _config(jcli), "--pitch", "{}",
             "--batch-size", "0"])
        return rc, dict(fake.written["ark:feats.ark"])


@pytest.mark.parametrize("batch", ["2", "0"])
def test_kaldi_tables_pitch(fake_kaldi, batch):
    fake_kaldi.tables["ark:wav.ark"] = _pitch_table()
    rc = tcli.compute_feats_from_kaldi_tables(
        ["ark:wav.ark", "ark:feats.ark", _config(tcli), "--pitch", "{}", "--batch-size", batch])
    jrc, want = _jax_pitch_output()
    assert rc == jrc == 0
    got = fake_kaldi.written["ark:feats.ark"]
    assert list(got) == list(want)
    for utt in want:
        assert got[utt].shape == want[utt].shape and got[utt].shape[1] == 13, utt
        np.testing.assert_allclose(got[utt][:, :10], want[utt][:, :10], rtol=0, atol=TOL)
        np.testing.assert_allclose(got[utt][:, 10:], want[utt][:, 10:], rtol=0, atol=TOL_PITCH)


def _pitch_case_table(case):
    """The pitch cases' tables: "short" adds utterances too short for one
    tracker frame (375 samples at 8 kHz), the two shortest sharing a
    batch of 2 the tracker never runs on, the third beside a tracked row;
    "stack" is :func:`_pitch_table`."""
    table = _pitch_table()
    if case == "short":
        rng = np.random.RandomState(24)
        table = {**dict(list(table.items())[:3]),
                 **{f"short{n}": _wave_entry(rng, seconds=n / 8000) for n in (210, 240, 300)}}
    return table


_PITCH_CASE_ARGS = {"short": (), "stack": ("--postprocess",
                                           json.dumps([{"name": "stack", "num_vectors": 3}]))}


@functools.lru_cache(maxsize=None)
def _jax_pitch_case_output(case):
    """The JAX command's --pitch output (host path) on a pitch case."""
    with pytest.MonkeyPatch.context() as mp:
        fake = _install_fake(mp)
        fake.tables["ark:wav.ark"] = _pitch_case_table(case)
        rc = jcli.compute_feats_from_kaldi_tables(
            ["ark:wav.ark", "ark:feats.ark", _config(jcli), "--pitch", "{}",
             "--batch-size", "0", *_PITCH_CASE_ARGS[case]])
        return rc, dict(fake.written["ark:feats.ark"])


@pytest.mark.parametrize("batch", ["2", "0"])
@pytest.mark.parametrize("case", ["short", "stack"])
def test_kaldi_tables_pitch_cases(fake_kaldi, case, batch, caplog):
    """Utterances too short to track get zero columns; after a stack the
    columns are pasted to the stacked rows, with one warning a run."""
    fake_kaldi.tables["ark:wav.ark"] = _pitch_case_table(case)
    with caplog.at_level("WARNING", logger=tcli.logger.name):
        rc = tcli.compute_feats_from_kaldi_tables(
            ["ark:wav.ark", "ark:feats.ark", _config(tcli), "--pitch", "{}",
             "--batch-size", batch, *_PITCH_CASE_ARGS[case]])
    warned = [r for r in caplog.records
              if r.name == tcli.logger.name and "--pitch pastes row-for-row" in r.getMessage()]
    assert len(warned) == (case == "stack")
    jrc, want = _jax_pitch_case_output(case)
    assert rc == jrc == 0
    got = fake_kaldi.written["ark:feats.ark"]
    assert list(got) == list(want) and len(got) == (6 if case == "short" else 4)
    width = 13 if case == "short" else 33
    for utt in want:
        assert got[utt].shape == want[utt].shape and got[utt].shape[1] == width, utt
        if utt.startswith("short"):
            assert got[utt].shape[0] and not got[utt][:, -3:].any(), utt
        np.testing.assert_allclose(got[utt][:, :-3], want[utt][:, :-3], rtol=0, atol=TOL)
        np.testing.assert_allclose(got[utt][:, -3:], want[utt][:, -3:], rtol=0, atol=TOL_PITCH)


@pytest.mark.parametrize("batch", ["4", "0"])
def test_kaldi_tables_vad_trim(fake_kaldi, batch):
    rng = np.random.RandomState(23)
    entries = {}
    for i in range(6):
        buff, rate, dur = _wave_entry(rng, seconds=0.4 + 0.13 * i)
        buff[:, : buff.shape[1] // 3] *= 1e-6  # a quiet head to trim
        entries[f"utt{i}"] = (buff, rate, dur)
    entries["silent"] = (np.full((1, 3200), 1e-8), 8000.0, 0.4)
    fake_kaldi.tables["ark:wav.ark"] = entries
    runs = _both(fake_kaldi, "ark:wav.ark", "vad", "--vad-trim", '{"frames_context": 2}',
                 "--batch-size", batch, cfg=dict(COMPUTER_CONFIG, include_energy=True))
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert "silent" not in runs["torch"][1]  # no voiced frames -> no output
    _close(runs["torch"][1], runs["jax"][1])
    assert any(m.shape[0] < 40 + 13 * i for i, m in enumerate(runs["torch"][1].values()))


# --- native tables (tests/test_kaldi_native.py) --------------------------

native = pytest.mark.skipif(not _no_bindings(), reason="real pydrobert-kaldi present")
RNG = np.random.RandomState(1234)


def _pcm_wave(channels, samples, rate=8000.0):
    data = np.round(RNG.randn(channels, samples) * 3000).astype(np.float32)
    return kt.WaveData(data, rate)


def _native_both(tmp_path, rspec, tag, *extra, scp=False):
    """Both packages' command into ``ark`` (or ``ark,scp``) files under
    ``tmp_path``: their (rc, table read back)."""
    out = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        ark = str(tmp_path / f"{tag}_{name}.ark")
        if scp:
            scp_path = str(tmp_path / f"{tag}_{name}.scp")
            wspec, read = f"ark,scp:{ark},{scp_path}", "scp:" + scp_path
        else:
            wspec, read = "ark:" + ark, "ark:" + ark
        rc = cli.compute_feats_from_kaldi_tables([rspec, wspec, _config(cli), *extra])
        out[name] = (rc, dict(kt.iter_table(read)) if rc == 0 else {})
    return out


@native
@pytest.mark.parametrize("batch_size", [0, 4])
def test_cli_kaldi_tables_native_end_to_end(tmp_path, batch_size):
    wav_ark = str(tmp_path / "wav.ark")
    with kt.KaldiTableWriter("ark:" + wav_ark) as writer:
        for i in range(7):
            writer.write(f"utt{i}", _pcm_wave(1, 2000 + 321 * i))
    runs = _native_both(tmp_path, "ark:" + wav_ark, "feat", "--batch-size", str(batch_size),
                        scp=True)
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert list(runs["torch"][1]) == [f"utt{i}" for i in range(7)]
    _close(runs["torch"][1], runs["jax"][1])


@native
def test_cli_kaldi_tables_native_missing_table(tmp_path):
    runs = _native_both(tmp_path, "scp:" + str(tmp_path / "missing.scp"), "out")
    assert runs["torch"][0] == runs["jax"][0] == 1


@native
def test_cli_compress_output(tmp_path):
    wav_ark = str(tmp_path / "wav.ark")
    with kt.KaldiTableWriter("ark:" + wav_ark) as writer:
        writer.write("utt0", _pcm_wave(1, 4000))
    plain = _native_both(tmp_path, "ark:" + wav_ark, "plain")
    comp = _native_both(tmp_path, "ark:" + wav_ark, "comp", "--compress")
    p, c = plain["torch"][1]["utt0"], comp["torch"][1]["utt0"]
    assert np.abs(c - p).max() <= float(p.max() - p.min()) / 255 * 4
    assert os.path.getsize(tmp_path / "comp_torch.ark") < os.path.getsize(
        tmp_path / "plain_torch.ark") / 2.5
    with open(tmp_path / "comp_torch.ark", "rb") as f:
        assert b"CM " in f.read()
    _close(plain["torch"][1], plain["jax"][1])
    # the port's compressed features against the JAX package's plain ones:
    # the reference's compression bound plus the float tier's
    j = plain["jax"][1]["utt0"]
    assert np.abs(c - j).max() <= float(p.max() - p.min()) / 255 * 4 + TOL
    assert comp["jax"][0] == 0


def _ark(tmp_path, name, mats):
    path = str(tmp_path / name)
    with kt.KaldiTableWriter("ark:" + path) as writer:
        for key, mat in mats.items():
            writer.write(key, mat)
    return path


def test_copy_feats_tables_round_trips(tmp_path):
    mats = {f"u{i}": RNG.randn(10 + i, 6).astype(np.float32) for i in range(4)}
    src = _ark(tmp_path, "src.ark", mats)
    for name, cli in (("torch", tcli), ("jax", jcli)):
        text = str(tmp_path / f"t_{name}.ark")
        back = str(tmp_path / f"b_{name}.ark")
        assert cli.copy_feats_tables(["ark:" + src, "ark,t:" + text]) == 0
        assert cli.copy_feats_tables(["ark:" + text, "ark:" + back]) == 0
        comp = str(tmp_path / f"c_{name}.ark")
        assert cli.copy_feats_tables(["ark:" + src, "ark:" + comp, "--compress", "2"]) == 0
        pt_dir = str(tmp_path / f"ptdir_{name}")
        assert cli.copy_feats_tables(["ark:" + src, "dir:" + pt_dir]) == 0
        assert sorted(os.listdir(pt_dir)) == [f"u{i}.pt" for i in range(4)]
        dir_ark = str(tmp_path / f"d_{name}.ark")
        assert cli.copy_feats_tables(["dir:" + pt_dir, "ark:" + dir_ark]) == 0
    for stem in ("t", "b", "c", "d"):  # the same bytes from both packages
        with open(tmp_path / f"{stem}_torch.ark", "rb") as f, \
                open(tmp_path / f"{stem}_jax.ark", "rb") as g:
            assert f.read() == g.read(), stem
    got = dict(kt.iter_table("ark:" + str(tmp_path / "d_torch.ark")))
    for key, mat in mats.items():
        np.testing.assert_array_equal(got[key], mat)
        # the port's .pt files are host float32 tensors, read by torch.load
        pt = torch.load(str(tmp_path / "ptdir_torch" / f"{key}.pt"))
        assert pt.device.type == "cpu" and pt.dtype == torch.float32


def test_copy_feats_tables_errors(tmp_path):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for cli in (tcli, jcli):
        assert cli.copy_feats_tables(
            ["ark:" + str(tmp_path / "missing.ark"), "ark:" + str(tmp_path / "o.ark")]) == 1
        assert cli.copy_feats_tables(["dir:" + empty, "ark:" + str(tmp_path / "e.ark")]) == 1


def test_text_round_trip_preserves_double_precision(tmp_path):
    stats = np.array([[1234567890.123456, 42.0], [9876543210.987654, 0.0]], np.float64)
    a1 = _ark(tmp_path, "a1.ark", {"s": stats})
    t, a2 = str(tmp_path / "t.ark"), str(tmp_path / "a2.ark")
    assert tcli.copy_feats_tables(["ark:" + a1, "ark,t:" + t]) == 0
    assert tcli.copy_feats_tables(["ark:" + t, "ark:" + a2]) == 0
    got = dict(kt.iter_table("ark:" + a2))["s"]
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, stats)


@native
def test_cli_segments(tmp_path):
    wav_ark = str(tmp_path / "wav.ark")
    with kt.KaldiTableWriter("ark:" + wav_ark) as writer:
        writer.write("recA", _pcm_wave(1, 16000))
        writer.write("recB", _pcm_wave(1, 8000))
    seg_path = str(tmp_path / "segments")
    with open(seg_path, "w") as f:
        f.write("recA-1 recA 0.25 1.00\n")  # plain cut
        f.write("recA-2 recA 1.50 -1\n")  # to the end
        f.write("recA-3 recA 1.90 2.25\n")  # overshoots 0.25 s: clamp
        f.write("recA-4 recA 1.00 3.00\n")  # overshoots 1 s: skip
        f.write("recA-5 recA 0.50 0.55\n")  # < 0.1 s: skip
        f.write("recB-1 recB 0.00 0.50\n")
        f.write("recC-1 recC 0.00 1.00\n")  # recording absent: warn
    runs = _native_both(tmp_path, "ark:" + wav_ark, "feat", "--segments", seg_path)
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert sorted(runs["torch"][1]) == ["recA-1", "recA-2", "recA-3", "recB-1"]
    _close(runs["torch"][1], runs["jax"][1])


@native
def test_cli_segments_bad_lines(tmp_path, capsys):
    wav_ark = str(tmp_path / "wav.ark")
    with kt.KaldiTableWriter("ark:" + wav_ark) as writer:
        writer.write("rec", _pcm_wave(1, 800))
    for bad in ("utt rec 0.5\n", "utt rec 1.0 0.5\n", "utt rec x y\n"):
        seg = str(tmp_path / "seg")
        with open(seg, "w") as f:
            f.write(bad)
        runs = _native_both(tmp_path, "ark:" + wav_ark, "f", "--segments", seg)
        assert runs["torch"][0] == runs["jax"][0] == 1, bad
        assert capsys.readouterr().err.count("--segments") == 2


@native
def test_signals_cli_wav_scp_pipe_entries(tmp_path):
    wav_path = str(tmp_path / "a.wav")
    with open(wav_path, "wb") as f:
        kt.write_wave(f, _pcm_wave(1, 4000))
    map_path = str(tmp_path / "wav.scp")
    with open(map_path, "w") as f:
        f.write(f"piped cat {wav_path} |\n")
        f.write(f"plain {wav_path}\n")
    outs = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        out = str(tmp_path / f"feats_{name}")
        assert cli.signals_to_torch_feat_dir([map_path, _config(cli), out]) == 0
        outs[name] = {u: torch.load(os.path.join(out, u + ".pt")).numpy()
                      for u in ("piped", "plain")}
    assert outs["torch"]["piped"].shape[1] == 10
    np.testing.assert_array_equal(outs["torch"]["piped"], outs["torch"]["plain"])
    _close(outs["torch"], outs["jax"])
