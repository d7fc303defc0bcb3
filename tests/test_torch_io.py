"""speech_tpu_torch.io (the port's copy of the host I/O) against
speech_tpu.io: bit-equal reads and probes of every file under
tests/audio, Kaldi tables that round-trip between the two, and the native
shorten decoder equal to the Python one."""

import glob
import os

import numpy as np
import pytest
import torch

import speech_tpu.io as JIO
from speech_tpu.io import kaldi_tables as jkt

import speech_tpu_torch.io as TIO
from speech_tpu_torch.io import _native, sphere
from speech_tpu_torch.io import kaldi_tables as tkt

AUDIO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "audio")
AUDIO = sorted(glob.glob(os.path.join(AUDIO_DIR, "*")))
SHN = sorted(glob.glob(os.path.join(AUDIO_DIR, "*_shn.sph")))


def _outcome(fn, *args, **kw):
    """``fn``'s result, or the type of what it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # the two packages must fail alike
        return type(e)


@pytest.mark.parametrize("path", AUDIO, ids=os.path.basename)
def test_read_and_probe_bit_equal(path):
    for dtype in (None, np.float64):
        got = _outcome(TIO.read_signal, path, dtype=dtype)
        want = _outcome(JIO.read_signal, path, dtype=dtype)
        if isinstance(want, type):
            assert got is want, (path, got, want)
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert TIO.probe_signal_info(path) == JIO.probe_signal_info(path)
    with open(path, "rb") as f:
        data = f.read()
    got = TIO.wds_read_signal(os.path.basename(path), data)
    want = JIO.wds_read_signal(os.path.basename(path), data)
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got, want)


def _decode(path, decoder):
    with open(path, "rb") as f:
        (_, _, sampcount, _, chancount, _) = sphere.read_sphere_header(f)
        data = np.zeros(sampcount * chancount, dtype=np.int16)
        done = decoder(f.read(16384), f, data, chancount)
    return done, data


@pytest.mark.parametrize("path", SHN, ids=os.path.basename)
def test_native_decoder_matches_python(path, monkeypatch):
    assert _native.get_shorten_lib() is not None
    assert os.path.dirname(_native._so_path()).endswith(os.path.join("build", "speech_tpu_torch"))
    done_c, data_c = _decode(path, sphere._try_decode_shortened_native)
    done_py, data_py = _decode(path, lambda pre, f, data, _: sphere._decode_shortened(pre, f, data))
    assert done_c == done_py and np.array_equal(data_c, data_py)
    native = TIO.read_signal(path)
    assert np.array_equal(native, TIO.read_signal(path.replace("_shn.sph", ".wav")))
    # without the library, read_signal decodes the whole file in Python
    monkeypatch.setattr(_native, "get_shorten_lib", lambda: None)
    assert np.array_equal(TIO.read_signal(path), native)
    with open(path, "rb") as f:
        assert np.array_equal(TIO.read_signal(f, force_as="sph"), native)


def test_native_rejects_garbage():
    with pytest.raises(IOError):
        _native.decode_shorten_native(b"not a shorten stream at all", 64, sphere.ULAW_OUTWARD)


def test_containers_round_trip(tmp_path):
    x = np.random.RandomState(0).randn(3, 5)
    np.save(str(tmp_path / "x.npy"), x)
    np.savez(str(tmp_path / "x.npz"), x, named=2 * x)
    torch.save(torch.tensor(x), str(tmp_path / "x.pt"))
    x.tofile(str(tmp_path / "x.bin"))
    for name, kw, want in (
        ("x.npy", {}, x),
        ("x.npz", {}, x),
        ("x.npz", {"key": "named"}, 2 * x),
        ("x.pt", {}, x),
        ("x.bin", {"force_as": "file"}, x.ravel()),
        ("x.npy", {"dtype": np.float32}, x.astype(np.float32)),
    ):
        path = str(tmp_path / name)
        got = TIO.read_signal(path, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, kw)
        assert np.array_equal(got, JIO.read_signal(path, **kw))
    with pytest.raises(IOError):
        TIO.read_signal("mystery.xyz")
    with pytest.raises(ValueError, match="could be"):
        TIO.read_signal(str(tmp_path / "x.npy"), force_as="flac")


@pytest.mark.parametrize("spec", ["ark", "ark,t", "ark,scp"])
def test_kaldi_tables_round_trip(tmp_path, spec):
    rng = np.random.RandomState(1)
    values = {"utt1": rng.randn(4, 3), "utt2": rng.randn(2, 3).astype(np.float32),
              "utt3": rng.randn(5)}
    ark, scp = str(tmp_path / "t.ark"), str(tmp_path / "t.scp")
    wspec = f"{spec}:{ark}" if spec != "ark,scp" else f"ark,scp:{ark},{scp}"
    with tkt.KaldiTableWriter(wspec) as w:
        for key, value in values.items():
            w.write(key, value)
    rspec = f"scp:{scp}" if spec == "ark,scp" else f"ark:{ark}"
    for i, (key, value) in enumerate(values.items()):
        tol = 1e-6 if spec == "ark,t" else 0
        for read in (TIO.read_signal, JIO.read_signal):
            assert np.allclose(read(rspec, key=key), value, rtol=tol, atol=0)
            assert np.allclose(read(rspec, key=i), value, rtol=tol, atol=0)
    # the two writers give the same bytes, and each package reads the other's
    paths = {}
    for name, mod in (("jax", jkt), ("torch", tkt)):
        paths[name] = str(tmp_path / f"{name}.ark")
        opts = "ark,t" if spec == "ark,t" else "ark"
        with mod.KaldiTableWriter(f"{opts}:{paths[name]}") as w:
            for key, value in values.items():
                w.write(key, value)
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    assert [k for k, _ in tkt.iter_table(f"ark:{paths['jax']}")] == list(values)
