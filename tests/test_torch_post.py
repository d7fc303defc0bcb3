"""speech_tpu_torch.post (host numpy classes) against speech_tpu.post: the
same outputs in float64, statistics and transforms from files too."""

import numpy as np
import pytest

import speech_tpu.post as jpost
from speech_tpu.alias import alias_factory_subclass_from_arg as j_factory

import speech_tpu_torch.post as tpost
from speech_tpu_torch.alias import alias_factory_subclass_from_arg as t_factory

# the classes are copies; the only arithmetic that differs is SlidingCMVN's
# (the port delegates to its torch twin, in float64)
TOL = 1e-10

CONFIGS = [
    {"name": "deltas", "num_deltas": 2},
    {"name": "deltas", "num_deltas": 1, "concatenate": False, "context_window": 3},
    {"name": "deltas", "num_deltas": 1, "pad_mode": "reflect"},
    {"name": "stack", "num_vectors": 3},
    {"name": "stack", "num_vectors": 4, "pad_mode": "edge"},
    {"name": "pcen", "smooth": 0.1},
    {"name": "pcen", "alpha": [0.5, 0.6, 0.7, 0.8, 0.9], "delta": 1.0},
    {"name": "sliding_cmvn", "window": 9, "min_window": 3},
    {"name": "sliding_cmvn", "window": 9, "center": False, "norm_var": True, "min_window": 3},
    {"name": "dct", "num_ceps": 4, "lifter": 22},
    {"name": "mfcc"},
    {"name": "splice", "left": 2, "right": 1},
    {"name": "standardize"},
    {"name": "cmvn", "norm_var": False},
    {"name": "transform", "matrix": np.arange(30.0).reshape(6, 5) / 7},
    {"name": "affine", "matrix": np.arange(18.0).reshape(3, 6) / 5},
]
IDS = [f"{c['name']}{i}" for i, c in enumerate(CONFIGS)]


def _feats(shape=(37, 5), seed=0, positive=False):
    x = np.random.RandomState(seed).randn(*shape)
    return np.abs(x) + 0.1 if positive else x


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_apply_matches_jax(cfg):
    jp = j_factory(jpost.PostProcessor, dict(cfg))
    tp = t_factory(tpost.PostProcessor, dict(cfg))
    assert type(tp).__name__ == type(jp).__name__
    x = _feats(positive=cfg["name"] == "pcen")
    want = jp.apply(x.copy())
    got = tp.apply(x.copy())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    if cfg["name"] in ("deltas", "stack", "splice", "dct", "transform", "affine"):
        want32 = jp.apply(x.astype(np.float32))
        got32 = tp.apply(x.astype(np.float32))
        assert got32.dtype == want32.dtype and np.array_equal(got32, want32)


@pytest.mark.parametrize("name", ["deltas", "stack", "pcen", "sliding_cmvn"])
def test_apply_along_other_axes(name):
    cfg = {
        "deltas": {"num_deltas": 1, "target_axis": 0},
        "stack": {"num_vectors": 2, "time_axis": 1, "pad_mode": "edge"},
        "pcen": {"time_axis": 1},
        "sliding_cmvn": {"window": 5, "time_axis": 1, "min_window": 2},
    }[name]
    x = _feats((5, 23), positive=True)
    jp = j_factory(jpost.PostProcessor, {"name": name, **cfg})
    tp = t_factory(tpost.PostProcessor, {"name": name, **cfg})
    axis = 0 if name != "deltas" else -1
    assert np.abs(tp.apply(x, axis=axis) - jp.apply(x, axis=axis)).max() <= TOL


def test_standardize_statistics_match_jax():
    x = _feats((3, 20, 5))
    js, ts = jpost.Standardize(), tpost.Standardize()
    for chunk in (x[0], x[1], x[2, :7]):
        js.accumulate(chunk)
        ts.accumulate(chunk)
    assert np.array_equal(js.stats, ts.stats) and ts.have_stats
    y = _feats((9, 5), seed=1)
    assert np.array_equal(ts.apply(y), js.apply(y))
    fs = tpost.Standardize.from_stats(js.stats, norm_var=False)
    assert np.array_equal(fs.apply(y), jpost.Standardize.from_stats(js.stats, norm_var=False).apply(y))
    with pytest.raises(ValueError):
        ts.apply(_feats((4, 6)))
    with pytest.raises(ValueError):
        tpost.Standardize.from_stats(np.zeros((3, 4)))


def test_standardize_edge_cases_match_jax(tmp_path):
    lone = np.ones((1, 4))
    for mod in (jpost, tpost):
        with pytest.raises(ValueError):
            mod.Standardize().apply(lone)
        with pytest.warns(UserWarning):
            assert not mod.Standardize(norm_var=False).apply(lone).any()
    const = np.ones((6, 3))
    const[:, 0] = np.arange(6)
    with pytest.warns(UserWarning):
        want = jpost.Standardize().apply(const)
    with pytest.warns(UserWarning):
        got = tpost.Standardize().apply(const)
    assert np.array_equal(got, want)
    ts = tpost.Standardize()
    ts.accumulate(_feats((8, 3)))
    for name in ("stats.npy", "stats.npz", "stats.bin"):
        path = str(tmp_path / name)
        ts.save(path)
        if name.endswith(".npy"):
            assert np.array_equal(np.load(path), ts.stats)
        elif name.endswith(".npz"):
            with np.load(path) as arch:
                assert np.array_equal(arch["arr_0"], ts.stats)
        else:
            assert np.array_equal(np.fromfile(path).reshape(2, 4), ts.stats)


def test_not_ported_paths_raise(tmp_path):
    """Every path of post.py is ported now: statistics and transforms load
    from files (.npy, raw binary, Kaldi tables) as the JAX package loads
    them."""
    from speech_tpu_torch.io import kaldi_tables as tkt

    ts = tpost.Standardize()
    ts.accumulate(_feats((8, 3), positive=True))  # raw stats must look plausible
    npy, raw, ark = (str(tmp_path / n) for n in ("stats.npy", "stats.bin", "stats.ark"))
    ts.save(npy)
    ts.stats.tofile(raw)
    with tkt.KaldiTableWriter(f"ark:{ark}") as w:
        w.write("global", ts.stats)
    y = _feats((9, 3), seed=2)
    for path, kw in ((npy, {}), (raw, {"force_as": "file"}), (f"ark:{ark}", {})):
        got, want = tpost.Standardize(path, **kw), jpost.Standardize(path, **kw)
        assert np.array_equal(got.stats, want.stats), path
        assert np.array_equal(got.stats, ts.stats), path
        assert np.array_equal(got.apply(y), want.apply(y))
    lda = np.arange(12.0).reshape(3, 4) / 7
    np.save(str(tmp_path / "lda.npy"), lda)
    tt = tpost.Transform(str(tmp_path / "lda.npy"))
    assert np.array_equal(tt.matrix, lda)
    assert np.array_equal(tt.apply(y), jpost.Transform(str(tmp_path / "lda.npy")).apply(y))
    np.array([-1.0, 2.5, 3.0]).tofile(str(tmp_path / "bad.bin"))
    with pytest.raises(IOError):
        tpost.Standardize(str(tmp_path / "bad.bin"), force_as="file")
    # PLP and VADTrim are ported (ops/plp.py, ops/vad.py): they build
    assert isinstance(
        t_factory(tpost.PostProcessor, {"name": "plp", "center_hz": [100.0, 200.0],
                                        "order": 2, "num_ceps": 3}),
        tpost.PLP,
    )
    assert isinstance(t_factory(tpost.PostProcessor, "vad_trim"), tpost.VADTrim)
    with pytest.raises(TypeError):
        tpost.Standardize(dtype="float32")
    with pytest.raises(ValueError):
        tpost.Transform()


def test_constructor_validation_matches_jax():
    bad = [
        ("stack", {"num_vectors": 0}),
        ("pcen", {"smooth": 0.0}),
        ("sliding_cmvn", {"window": 0}),
        ("dct", {"num_ceps": 0}),
        ("dct", {"lifter": -1.0}),
        ("splice", {"left": -1}),
        ("transform", {"matrix": np.zeros((0, 3))}),
    ]
    for name, kw in bad:
        for mod, factory in ((jpost, j_factory), (tpost, t_factory)):
            with pytest.raises(ValueError):
                factory(mod.PostProcessor, {"name": name, **kw})
    with pytest.raises(RuntimeError):
        tpost.DCT(num_ceps=9).apply(_feats((4, 5)))
    with pytest.raises(RuntimeError):
        tpost.Splice(time_axis=1).apply(_feats((4, 5)))
