"""The frozen reference of ``bench_port/reference/`` against the port's
``compute_full`` (float64, on the CPU), and the work count of
``bench_port/roofline.py`` against the kernel table's bounds."""

import json

import numpy as np
import pytest
import torch

from bench_port.common import HERE
from bench_port.reference.fbank import FbankSpec, frames_done_after
from bench_port.roofline import DIGIT_PAIRS, bound_s, feature_work

CONFIGS = ("fbank40-kaldi-double", "fbank80-wenet-float")


def _computer(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())["computer"]
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_compute_full(name):
    from speech_tpu_torch.alias import alias_factory_subclass_from_arg
    from speech_tpu_torch.compute import FrameComputer

    cfg = _computer(name)
    spec = FbankSpec(cfg)
    plain = {k: v for k, v in cfg.items() if k not in ("precision", "fft_mode")}
    port = alias_factory_subclass_from_arg(
        FrameComputer, {**plain, "dtype": "float64", "device": "cpu"})
    rng = np.random.default_rng(16)
    for n in (201, 250, 399, 1601, 16000, 47123):
        x = rng.standard_normal(n) * 0.05
        want = port.compute_full(x)
        got = spec.features(x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_tables_match_the_port(name):
    from speech_tpu_torch.alias import alias_factory_subclass_from_arg
    from speech_tpu_torch.compute import FrameComputer

    cfg = _computer(name)
    spec = FbankSpec(cfg)
    port = alias_factory_subclass_from_arg(FrameComputer, {**cfg, "device": "cpu"})
    np.testing.assert_allclose(spec.weights(), port._weights, rtol=0, atol=1e-14)
    cos, sin = spec.dft()
    np.testing.assert_allclose(cos, port._dft_cos, rtol=0, atol=1e-14)
    np.testing.assert_allclose(sin, port._dft_sin, rtol=0, atol=1e-14)
    assert spec.pad_left == port._pad_left


@pytest.mark.parametrize("precision", ["float32", "tf32"])
def test_controls_depart_from_float64(precision):
    spec = FbankSpec(_computer("fbank80-wenet-float"))
    x = (np.random.default_rng(1).standard_normal(32000) * 0.05).astype(np.float32)
    err = np.abs(spec.features(x, precision=precision) - spec.features(x)).max()
    lo, hi = {"float32": (1e-8, 1e-4), "tf32": (1e-4, 1e-1)}[precision]
    assert lo < err < hi


def test_frames_done_after_follows_the_stream():
    """A stream that has seen ``n`` samples can have emitted exactly the
    frames that read no later sample: the port's stream emits them."""
    from speech_tpu_torch.alias import alias_factory_subclass_from_arg
    from speech_tpu_torch.compute import FrameComputer
    from speech_tpu_torch.streaming import StreamingSTFT

    cfg = _computer("fbank80-wenet-float")
    spec = FbankSpec(cfg)
    comp = alias_factory_subclass_from_arg(
        FrameComputer, {**{k: v for k, v in cfg.items() if k != "fft_mode"}, "device": "cpu"})
    stream = StreamingSTFT(comp, 1600)
    total = 1600 * 7 + 333
    x = torch.tensor(np.random.default_rng(2).standard_normal(total) * 0.05,
                     dtype=torch.float32)
    state = stream.init_state()
    emitted = 0
    for c in range(0, total, 1600):
        piece = x[c: c + 1600]
        chunk = torch.zeros(1600)
        chunk[: piece.numel()] = piece
        state, _, n = stream._process_impl(state, chunk, piece.numel())
        emitted += int(n)
        if c + 1600 < total:
            assert emitted == frames_done_after(c + 1600, total, spec.frame_length,
                                                spec.frame_shift, spec.pad_left)
    _, n = stream._finalize_impl(state)
    assert emitted + int(n) == spec.frame_count(total)


MAIN = {"name": "stft", "bank": {"name": "fbank", "num_filts": 40, "sampling_rate": 16000},
        "frame_length_ms": 25, "frame_shift_ms": 10, "include_energy": True}


@pytest.mark.parametrize("route,tier,ms", [
    ("B2", "double", "0.761"), ("B2", "accurate", "0.602"),
    ("B1", "highest", "0.480"), ("B1", "default", "0.162"),
])
def test_roofline_reproduces_the_kernel_table(route, tier, ms):
    """PERF.md's kernel table: the main config (40 filters plus energy),
    128 x 15 s, 192,000 frames, one launch."""
    spec = FbankSpec(MAIN)
    ops, nbytes = feature_work(spec, route, tier, 128 * 1500, 128 * 15 * 16000)
    least, by = bound_s(ops, nbytes)
    assert f"{least * 1e3:.3f}" == ms
    assert by == "operations"


@pytest.mark.parametrize("tier, cutoff", [("double", 5), ("accurate", 4)])
def test_digit_pairs_follow_the_tier_rule_and_the_port(tier, cutoff):
    """The work count's pairs: 5 x 5 digits of base 128, the levels
    ``i + j <= cutoff`` (roofline.py's derivation), and the pairs the
    port's B2 schedule multiplies for the tier."""
    from speech_tpu_torch.ops import stft as port_stft

    assert DIGIT_PAIRS[tier] == sum(1 for i in range(5) for j in range(5) if i + j <= cutoff)
    rng = np.random.default_rng(16)
    C, S = rng.standard_normal((400, 257)), rng.standard_normal((400, 257))
    W = np.abs(rng.standard_normal((257, 8)))
    i8 = port_stft.int8_kernel_matrices(C, S, W, cutoff=cutoff)
    assert sum(len(xs) for _, xs, _, _ in i8["offsets"]) == DIGIT_PAIRS[tier]
