"""Per-speaker CMVN on the port's Kaldi CLI against the JAX CLI, on the CPU.

Twins of ``tests/test_cmvn_cli.py``: ``--cmvn-stats-out`` (Kaldi
``compute-cmvn-stats``) and ``--apply-cmvn`` / ``--utt2spk`` /
``--cmvn-norm-vars`` (``apply-cmvn``) on the native table I/O.  Both
packages run on the same wave archive; features within 1e-4 (the float
tier, ``tests/test_pallas.py:55``), statistics within rtol 1e-6 of the
statistics of the port's own features (as the reference test holds its
own), and table keys, frame counts and return codes equal.
"""

import json

import numpy as np
import pytest

import speech_tpu.command_line as jcli
from speech_tpu.post import Standardize as JStandardize

import speech_tpu_torch.command_line as tcli
from speech_tpu_torch.io import kaldi_tables as kt
from speech_tpu_torch.post import Standardize


def _no_bindings():
    try:
        import pydrobert.kaldi.io  # noqa: F401

        return False
    except ImportError:
        return True


pytestmark = pytest.mark.skipif(not _no_bindings(), reason="real pydrobert-kaldi present")

TOL = 1e-4
CONFIG = {
    "name": "stft",
    "bank": {"name": "fbank", "num_filts": 8, "sampling_rate": 8000},
    "frame_length_ms": 25,
    "frame_shift_ms": 10,
}


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.RandomState(7)
    wav_ark = str(tmp_path / "wav.ark")
    utt2spk_path = str(tmp_path / "utt2spk")
    spk_of = {}
    with kt.KaldiTableWriter("ark:" + wav_ark) as writer, open(utt2spk_path, "w") as u2s:
        for i in range(6):
            utt, spk = f"utt{i}", f"spk{i % 2}"
            spk_of[utt] = spk
            data = np.round(rng.randn(1, 1600 + 100 * i) * 2000).astype(np.float32)
            writer.write(utt, kt.WaveData(data, 8000.0))
            u2s.write(f"{utt} {spk}\n")
    return wav_ark, utt2spk_path, spk_of


def _extract(wav_ark, tmp_path, name, *extra, stats=None):
    """Both packages' features (and statistics, where ``stats`` names an
    archive): ``{package: (feats, stats)}``."""
    out = {}
    for pkg, cli, cfg in (("jax", jcli, CONFIG), ("torch", tcli, dict(CONFIG, device="cpu"))):
        ark = str(tmp_path / f"{name}_{pkg}.ark")
        args = ["ark:" + wav_ark, "ark:" + ark, json.dumps(cfg), *extra]
        stats_ark = None
        if stats is not None:
            stats_ark = str(tmp_path / f"{stats}_{pkg}.ark")
            args += ["--cmvn-stats-out", "ark:" + stats_ark]
        assert cli.compute_feats_from_kaldi_tables(args) == 0
        feats = dict(kt.iter_table("ark:" + ark))
        out[pkg] = (feats, None if stats_ark is None else dict(kt.iter_table("ark:" + stats_ark)))
    return out


def _close(got, want, tol=TOL):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_cmvn_stats_out_per_speaker(tmp_path, corpus):
    wav_ark, utt2spk, spk_of = corpus
    runs = _extract(wav_ark, tmp_path, "feats", "--utt2spk", utt2spk, stats="cmvn")
    feats, stats = runs["torch"]
    _close(feats, runs["jax"][0])
    assert sorted(stats) == sorted(runs["jax"][1]) == ["spk0", "spk1"]
    for spk in stats:
        ref = Standardize()
        for utt, mat in feats.items():
            if spk_of[utt] == spk:
                ref.accumulate(np.asarray(mat, np.float64))
        assert stats[spk].dtype == np.float64
        np.testing.assert_allclose(stats[spk], ref.stats, rtol=1e-6)
        assert stats[spk][0, -1] == runs["jax"][1][spk][0, -1]  # frame counts


def test_cmvn_stats_out_default_per_utterance(tmp_path, corpus):
    wav_ark, _, spk_of = corpus
    runs = _extract(wav_ark, tmp_path, "feats_u", stats="cmvn_u")
    feats, stats = runs["torch"]
    assert sorted(stats) == sorted(runs["jax"][1]) == sorted(spk_of)
    for utt, mat in feats.items():
        assert stats[utt][0, -1] == runs["jax"][1][utt][0, -1] == mat.shape[0]


@pytest.mark.parametrize("norm_vars", [False, True])
def test_apply_cmvn_round(tmp_path, corpus, norm_vars):
    """Both packages normalize with the same statistics archive."""
    wav_ark, utt2spk, spk_of = corpus
    raw = _extract(wav_ark, tmp_path, "raw", "--utt2spk", utt2spk, stats="cmvn")
    stats_ark = str(tmp_path / "cmvn_jax.ark")
    extra = ["--apply-cmvn", "ark:" + stats_ark, "--utt2spk", utt2spk]
    if norm_vars:
        extra.append("--cmvn-norm-vars")
    normed = _extract(wav_ark, tmp_path, "normed", *extra)
    _close(normed["torch"][0], normed["jax"][0])
    stats = dict(kt.iter_table("ark:" + stats_ark))
    got = normed["torch"][0]
    for utt, mat in raw["torch"][0].items():
        std = JStandardize.from_stats(stats[spk_of[utt]], norm_var=norm_vars)
        want = std.apply(np.asarray(mat, np.float64)).astype(np.float32)
        np.testing.assert_allclose(got[utt], want, atol=1e-5)
    for spk in ("spk0", "spk1"):
        pooled = np.concatenate([got[u] for u in got if spk_of[u] == spk])
        np.testing.assert_allclose(pooled.mean(0), 0.0, atol=1e-3)
        if norm_vars:
            np.testing.assert_allclose(pooled.std(0), 1.0, atol=1e-2)


def test_apply_cmvn_missing_speaker_skips(tmp_path, corpus):
    wav_ark, utt2spk, spk_of = corpus
    raw = _extract(wav_ark, tmp_path, "raw2", "--utt2spk", utt2spk, stats="cmvn_p")
    stats = raw["torch"][1]
    partial_ark = str(tmp_path / "cmvn_only0.ark")
    with kt.KaldiTableWriter("ark:" + partial_ark) as writer:
        writer.write("spk0", stats["spk0"])
    normed = _extract(wav_ark, tmp_path, "normed2", "--apply-cmvn", "ark:" + partial_ark,
                      "--utt2spk", utt2spk)
    assert sorted(normed["torch"][0]) == sorted(normed["jax"][0]) == sorted(
        u for u in raw["torch"][0] if spk_of[u] == "spk0")
    _close(normed["torch"][0], normed["jax"][0])


def test_cmvn_flags_mutually_exclusive(tmp_path, corpus, capsys):
    wav_ark, _, _ = corpus
    for cli, cfg in ((jcli, CONFIG), (tcli, dict(CONFIG, device="cpu"))):
        ret = cli.compute_feats_from_kaldi_tables(
            ["ark:" + wav_ark, "ark:" + str(tmp_path / "x.ark"), json.dumps(cfg),
             "--cmvn-stats-out", "ark:" + str(tmp_path / "s.ark"),
             "--apply-cmvn", "ark:" + str(tmp_path / "s.ark")]
        )
        assert ret == 2  # argparse mutual-exclusion error
    capsys.readouterr()


def test_bad_utt2spk(tmp_path, corpus, capsys):
    wav_ark, _, _ = corpus
    bad = str(tmp_path / "u2s")
    with open(bad, "w") as f:
        f.write("utt0 spk0 extra\n")
    for cli, cfg in ((jcli, CONFIG), (tcli, dict(CONFIG, device="cpu"))):
        ret = cli.compute_feats_from_kaldi_tables(
            ["ark:" + wav_ark, "ark:" + str(tmp_path / "y.ark"), json.dumps(cfg),
             "--cmvn-stats-out", "ark:" + str(tmp_path / "s.ark"), "--utt2spk", bad]
        )
        assert ret == 1
        assert "utt2spk" in capsys.readouterr().err
