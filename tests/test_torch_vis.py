"""The port's plots (speech_tpu_torch.vis) against speech_tpu.vis
(tests/test_corpus_vis.py): the same boundaries, and the same arrays
drawn, on the same configs and signal (matplotlib's Agg backend)."""

import numpy as np
import pytest

import speech_tpu.vis as jvis
import speech_tpu_torch.vis as tvis
from speech_tpu import post as jpost
from speech_tpu.alias import alias_factory_subclass_from_arg as jalias
from speech_tpu.compute import SIFrameComputer as JSI
from speech_tpu.compute import STFTFrameComputer as JSTFT
from speech_tpu.filters import LinearFilterBank as JBank
from speech_tpu_torch import post as tpost
from speech_tpu_torch.alias import alias_factory_subclass_from_arg as talias
from speech_tpu_torch.compute import SIFrameComputer as TSI
from speech_tpu_torch.compute import STFTFrameComputer as TSTFT
from speech_tpu_torch.filters import LinearFilterBank as TBank

BANKS = [
    {"name": "fbank", "num_filts": 8, "sampling_rate": 8000},
    {"name": "gammatone", "num_filts": 10, "sampling_rate": 16000, "scaling_function": "mel"},
    {"name": "tri", "num_filts": 6, "sampling_rate": 8000, "scaling_function": "bark"},
]
TOL = 1e-6


@pytest.fixture(scope="module")
def plt():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


def _pair(bank, **kw):
    return (JSTFT(dict(bank), dtype="float64", **kw),
            TSTFT(dict(bank), dtype="float64", device="cpu", **kw))


@pytest.mark.parametrize("bank", BANKS, ids=lambda b: b["name"])
def test_hz_feature_bounds_equal(bank):
    jc, tc = _pair(bank, frame_length_ms=25)
    assert np.array_equal(jvis._hz_feature_bounds(jc), tvis._hz_feature_bounds(tc))


@pytest.mark.parametrize("style", ["centered", "causal"])
@pytest.mark.parametrize("num_samples", [200, 4000, 4093])
def test_time_bounds_equal(style, num_samples):
    jc, tc = _pair(BANKS[0], frame_length_ms=25, frame_style=style)
    assert np.array_equal(jvis._time_bounds(jc, num_samples), tvis._time_bounds(tc, num_samples))
    for vis, c in ((jvis, jc), (tvis, tc)):
        with pytest.raises(ValueError, match="too short"):
            vis._time_bounds(c, 10)


def _lines(fig):
    return [(line.get_xdata(), line.get_ydata()) for ax in fig.axes for line in ax.get_lines()]


@pytest.mark.parametrize("x_scale", ["hz", "ang", "bins"])
@pytest.mark.parametrize("y_scale", ["dB", "power", "real", "imag", "both"])
def test_plot_frequency_response_draws_the_same(plt, x_scale, y_scale):
    figs = [
        vis.plot_frequency_response([alias(Bank, dict(b)) for b in BANKS[:1] + BANKS[2:]],
                                    x_scale=x_scale, y_scale=y_scale, title="t")
        for vis, alias, Bank in ((jvis, jalias, JBank), (tvis, talias, TBank))
    ]
    want, got = (_lines(f) for f in figs)
    assert len(got) == len(want) > 0
    for (wx, wy), (gx, gy) in zip(want, got):
        assert np.abs(np.asarray(gx) - wx).max() <= TOL
        assert np.abs(np.asarray(gy) - wy).max() <= TOL
    assert [a.get_xlabel() for a in figs[0].axes] == [a.get_xlabel() for a in figs[1].axes]
    for f in figs:
        plt.close(f)


def _meshes(fig):
    return [(ax.collections[0].get_coordinates(), np.asarray(ax.collections[0].get_array()),
             ax.get_ylabel(), ax.get_xlim()) for ax in fig.axes]


@pytest.mark.parametrize("energy", [False, True], ids=["", "energy"])
def test_compare_feature_frames_draws_the_same(plt, energy):
    signal = np.random.RandomState(63).randn(4000)
    bank = BANKS[1]
    figs = []
    for vis, stft, si, post, dev in ((jvis, JSTFT, JSI, jpost, {}),
                                     (tvis, TSTFT, TSI, tpost, {"device": "cpu"})):
        computers = [stft(dict(bank), frame_length_ms=25, include_energy=energy,
                          dtype="float64", **dev),
                     si(dict(bank), dtype="float64", **dev)]
        figs.append(vis.compare_feature_frames(
            computers, signal, plot_titles=("stft", "si"),
            post_ops=[post.Standardize()], title="compare"))
    want, got = (_meshes(f) for f in figs)
    assert len(got) == len(want) == 2
    for (wc, wa, wl, wx), (gc, ga, gl, gx) in zip(want, got):
        assert gl == wl and np.allclose(gx, wx, rtol=0, atol=TOL)
        assert gc.shape == wc.shape and np.abs(gc - wc).max() <= TOL
        assert ga.shape == wa.shape and np.abs(ga - wa).max() <= TOL
    for f in figs:
        plt.close(f)


def test_compare_feature_frames_rejects_what_the_reference_rejects(plt):
    c = TSTFT(dict(BANKS[0]), frame_length_ms=25, device="cpu")
    with pytest.raises(ValueError):
        tvis.compare_feature_frames(c, np.zeros(10))
    with pytest.raises(ValueError, match="one plot title"):
        tvis.compare_feature_frames(c, np.zeros(4000), plot_titles=("a", "b"))
    with pytest.raises(ValueError, match="at least one filter"):
        tvis.plot_frequency_response([])
