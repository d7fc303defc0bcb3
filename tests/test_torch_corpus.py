"""speech_tpu_torch.corpus against speech_tpu.corpus, on the CPU.

Twins of the corpus cases of ``tests/test_corpus_vis.py``:
``post_process_wrapper`` (a copy: equal outputs) and ``FeatureCorpus`` in
extractor mode (float64 computers, the port's on ``device="cpu"``: batches
of the same utterances within 1e-8, the float64 tolerance of
``tests/test_torch_parallel.py``), with worker threads and seeded
preprocessors, and in feature-file mode (``.npy`` files and ark entries read
back exactly).
"""

import wave

import numpy as np
import pytest

from speech_tpu import corpus as jcorpus
from speech_tpu import post as jpost

from speech_tpu_torch import corpus as tcorpus
from speech_tpu_torch.io import kaldi_tables as kt

TOL64 = 1e-8
COMPUTER = {
    "name": "stft",
    "bank": {"name": "fbank", "num_filts": 8, "sampling_rate": 8000},
    "frame_length_ms": 25,
    "dtype": "float64",
}


class _FakeData:
    """Duck-typed stand-in for a pydrobert-kaldi Data iterator."""

    def __init__(self, table, num_sub=1, **kwargs):
        self.table = table
        self.num_sub = num_sub

    def batch_generator(self, repeat=False):
        yield from self.table


def test_post_process_wrapper_single():
    rng = np.random.RandomState(60)
    batches = [rng.randn(4, 10) for _ in range(3)]
    got = list(tcorpus.post_process_wrapper(_FakeData)(
        [b.copy() for b in batches], postprocessors=[{"name": "standardize"}]).batch_generator())
    want = list(jcorpus.post_process_wrapper(_FakeData)(
        [b.copy() for b in batches], postprocessors=[{"name": "standardize"}]).batch_generator())
    ref = jpost.Standardize()
    for g, w, raw in zip(got, want, batches):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, ref.apply(raw.copy(), axis=-1))
    Wrapped = tcorpus.post_process_wrapper(_FakeData)
    assert Wrapped.__name__ == "_FakeData" and Wrapped.__doc__.endswith("(post-process wrapped)")


def test_post_process_wrapper_subbatches():
    rng = np.random.RandomState(61)
    batches = [(rng.randn(4, 10), rng.randn(4)) for _ in range(2)]

    def run(module):
        data = module.post_process_wrapper(_FakeData)(
            [(a.copy(), b.copy()) for a, b in batches], num_sub=2,
            postprocessors={0: [{"name": "standardize"}]}, postprocess_axis=0)
        return list(data.batch_generator())

    for (g0, g1), (w0, w1), (raw0, raw1) in zip(run(tcorpus), run(jcorpus), batches):
        np.testing.assert_array_equal(g0, w0)
        np.testing.assert_allclose(g0, jpost.Standardize().apply(raw0.copy(), axis=0))
        np.testing.assert_array_equal(g1, raw1)


def _wavs(tmp_path, seed, count, lengths, prefix):
    rng = np.random.RandomState(seed)
    utt2path = {}
    for i in range(count):
        path = str(tmp_path / f"{prefix}{i}.wav")
        sig = (rng.randn(lengths(rng)) * 1000).astype(np.int16)
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(sig.tobytes())
        utt2path[f"{prefix}{i}"] = path
    return utt2path


def _batches(fc):
    return [(list(utts), [np.asarray(f) for f in feats]) for utts, feats in fc]


def _assert_batches_close(got, want, tol=TOL64):
    assert [u for u, _ in got] == [u for u, _ in want]
    for (_, gf), (_, wf) in zip(got, want):
        for g, w in zip(gf, wf):
            assert isinstance(g, np.ndarray) and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_feature_corpus(tmp_path):
    utt2path = _wavs(tmp_path, 62, 7, lambda r: r.randint(2000, 5000), "u")
    kw = dict(batch_size=3, postprocessors=[{"name": "deltas", "num_deltas": 1}])
    fc = tcorpus.FeatureCorpus(dict(COMPUTER, device="cpu"), utt2path, **kw)
    assert len(fc) == 3
    got = _batches(fc)
    assert {u for utts, _ in got for u in utts} == set(utt2path)
    assert all(f.shape[1] == 16 and np.isfinite(f).all() for _, fs in got for f in fs)
    _assert_batches_close(got, _batches(jcorpus.FeatureCorpus(dict(COMPUTER), utt2path, **kw)))
    # "fine" length buckets pad less and change no row
    fine = tcorpus.FeatureCorpus(dict(COMPUTER, device="cpu"), utt2path, bucket="fine", **kw)
    _assert_batches_close(_batches(fine), got, tol=0)


def test_feature_corpus_with_workers(tmp_path):
    utt2path = _wavs(tmp_path, 64, 5, lambda r: 3000, "w")
    kw = dict(batch_size=2, num_workers=3, preprocessors=[{"name": "preemphasize"}], seed=1)
    fc = tcorpus.FeatureCorpus(dict(COMPUTER, device="cpu"), utt2path, **kw)
    first, again = _batches(fc), _batches(fc)
    assert {u for utts, _ in first for u in utts} == set(utt2path)
    _assert_batches_close(again, first, tol=0)  # deterministic across iterations
    _assert_batches_close(first, _batches(jcorpus.FeatureCorpus(dict(COMPUTER), utt2path, **kw)))


def test_feature_corpus_feature_file_mode(tmp_path):
    rng = np.random.RandomState(3)
    utt2path = []
    for i, t in enumerate((7, 13, 9, 21, 4)):
        path = str(tmp_path / f"utt{i}.npy")
        np.save(path, rng.randn(t, 6))
        utt2path.append((f"utt{i}", path))
    got = _batches(tcorpus.FeatureCorpus(None, utt2path, batch_size=2))
    assert all(len(u) == len(f) <= 2 for u, f in got)
    _assert_batches_close(got, _batches(jcorpus.FeatureCorpus(None, utt2path, batch_size=2)),
                          tol=0)
    for u, f in zip([u for us, _ in got for u in us], [f for _, fs in got for f in fs]):
        np.testing.assert_array_equal(f, np.load(dict(utt2path)[u]))
    with pytest.raises(ValueError, match="preprocessors"):
        list(tcorpus.FeatureCorpus(None, utt2path, batch_size=2, preprocessors=["dither"]))


def test_feature_corpus_feature_file_mode_ark(tmp_path):
    rng = np.random.RandomState(7)
    ark = str(tmp_path / "feats.ark")
    wants = {}
    with kt.KaldiTableWriter("ark:" + ark) as writer:
        for i, t in enumerate((5, 11, 8)):
            wants[f"utt{i}"] = rng.randn(t, 4).astype(np.float32)
            writer.write(f"utt{i}", wants[f"utt{i}"])
    utt2path = [(u, "ark:" + ark) for u in wants]
    got = _batches(tcorpus.FeatureCorpus(None, utt2path, batch_size=2))
    _assert_batches_close(got, _batches(jcorpus.FeatureCorpus(None, utt2path, batch_size=2)),
                          tol=0)
    seen = {u: f for us, fs in got for u, f in zip(us, fs)}
    assert set(seen) == set(wants)
    for u in wants:
        np.testing.assert_array_equal(seen[u], wants[u])
