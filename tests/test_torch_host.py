"""speech_tpu_torch host side: the numpy weight compilers are array-equal to
speech_tpu's, params_from_jax round-trips, and the port never imports jax
or speech_tpu."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import speech_tpu.filters as jfilters
import speech_tpu.scales as jscales
from speech_tpu.compute import STFTFrameComputer as JaxSTFT
from speech_tpu.ops import stft as jstft

import speech_tpu_torch.filters as tfilters
import speech_tpu_torch.scales as tscales
from speech_tpu_torch.alias import alias_factory_subclass_from_arg as t_factory
from speech_tpu_torch.compute import STFTFrameComputer, params_from_jax
from speech_tpu_torch.ops import stft as tstft

from speech_tpu.alias import alias_factory_subclass_from_arg as j_factory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _config_banks():
    with open(os.path.join(DATA, "fbank.json")) as f:
        from_json = json.load(f)["bank"]
    with open(os.path.join(DATA, "fbank.yaml")) as f:
        from_yaml = yaml.safe_load(f)["bank"]
    return [from_json, from_yaml]


BANKS = _config_banks() + [
    {"name": "fbank", "num_filts": 40, "sampling_rate": 16000},
    {"name": "tri", "num_filts": 23, "sampling_rate": 16000, "scaling_function": "mel"},
    {"name": "gabor", "num_filts": 20, "sampling_rate": 16000, "scaling_function": "mel"},
    {"name": "gammatone", "num_filts": 20, "sampling_rate": 16000, "scaling_function": "mel"},
]
BANK_IDS = ["json", "yaml", "fbank40", "tri", "gabor", "gammatone"]


def _banks(cfg):
    return (
        j_factory(jfilters.LinearFilterBank, dict(cfg)),
        t_factory(tfilters.LinearFilterBank, dict(cfg)),
    )


def _equal(a, b):
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dft", [256, 384, 512])
@pytest.mark.parametrize("cfg", BANKS, ids=BANK_IDS)
def test_host_builders_array_equal(cfg, dft):
    jb, tb = _banks(cfg)
    assert jb.supports == tb.supports and jb.supports_hz == tb.supports_hz
    K = min(400, dft)
    window = jfilters.HannWindow().get_impulse_response(K)
    assert _equal(window, tfilters.HannWindow().get_impulse_response(K))
    C, S = jstft.windowed_dft_matrices(window, dft)
    C2, S2 = tstft.windowed_dft_matrices(window, dft)
    assert _equal(C, C2) and _equal(S, S2)
    for use_power in (False, True):
        W = jstft.fold_bank_to_weights(jb, dft, use_power)
        assert _equal(W, tstft.fold_bank_to_weights(tb, dft, use_power))
    for margin in (False, True):
        p1, s1 = jstft.digitize_matrix(C, 5, 128.0, margin)
        p2, s2 = tstft.digitize_matrix(C, 5, 128.0, margin)
        assert _equal(p1, p2) and s1 == s2
    assert jstft.digit_pair_schedule(5, 6) == tstft.digit_pair_schedule(5, 6)
    assert jstft.digit_group_schedule(5, 6, K) == tstft.digit_group_schedule(5, 6, K)
    for a, b in zip(jstft.digit_group_matrices(C, S), tstft.digit_group_matrices(C, S)):
        assert _equal(np.asarray(a), np.asarray(b))
    for cutoff in (jstft._I8_CUTOFF, jstft._I8_ACC_CUTOFF):
        want = jstft.int8_kernel_matrices(C, S, W, cutoff=cutoff)
        got = tstft.int8_kernel_matrices(C, S, W, cutoff=cutoff)
        assert set(want) == set(got)
        assert want["offsets"] == got["offsets"]
        for key in set(want) - {"offsets"}:
            assert _equal(np.asarray(want[key]), np.asarray(got[key])), key


@pytest.mark.parametrize(
    "name", ["bartlett", "blackman", "hamming", "hanning", "gamma"]
)
def test_windows_array_equal(name):
    for width in (1, 2, 399, 400):
        want = j_factory(jfilters.WindowFunction, name).get_impulse_response(width)
        got = t_factory(tfilters.WindowFunction, name).get_impulse_response(width)
        assert _equal(want, got)


@pytest.mark.parametrize("name", ["linear", "octave", "mel", "bark", "vtln"])
def test_scales_array_equal(name):
    kw = {"low_hz": 20.0} if name in ("linear", "octave") else {}
    if name == "vtln":
        kw = {"scaling_function": "mel", "warp": 1.1}
    js = j_factory(jscales.ScalingFunction, {"name": name, **kw})
    ts = t_factory(tscales.ScalingFunction, {"name": name, **kw})
    hz = np.linspace(30.0, 7900.0, 57)
    assert _equal(js.hertz_to_scale(hz), ts.hertz_to_scale(hz))
    scale = js.hertz_to_scale(hz)
    assert _equal(js.scale_to_hertz(scale), ts.scale_to_hertz(scale))


def _as_numpy_params(params):
    return {
        k: (v if k == "i8k_offsets" else np.asarray(v)) for k, v in params.items()
    }


@pytest.mark.parametrize(
    "precision,dtype,frame_length_ms",
    [
        ("highest", "float32", 25),
        ("highest", "float64", 25),
        ("double", "float32", 25),
        ("accurate", "float32", 25),
        ("double", "float32", 24.875),  # dft 398: no int8 layout
    ],
)
def test_params_from_jax_round_trip(precision, dtype, frame_length_ms):
    """The port's own host build equals the converted JAX params bit for
    bit, and loading the converted params changes nothing."""
    bank = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
    kw = dict(
        frame_length_ms=frame_length_ms,
        frame_shift_ms=10,
        include_energy=True,
        dtype=dtype,
        precision=precision,
        pad_to_nearest_power_of_two=frame_length_ms == 25,
    )
    jc = JaxSTFT(dict(bank), **kw)
    tc = STFTFrameComputer(dict(bank), device="cpu", **kw)
    converted = params_from_jax(_as_numpy_params(jc.params))
    own = tc.params
    assert set(converted) == set(own) == tc.param_keys()
    for key, value in own.items():
        other = converted[key]
        if isinstance(value, torch.Tensor):
            assert value.dtype == other.dtype, key
            assert torch.equal(value, other), key
        else:
            assert type(value) is type(other) and value == other, key
    tc.load_params(converted)
    assert all(
        torch.equal(v, own[k]) if isinstance(v, torch.Tensor) else v == own[k]
        for k, v in tc.params.items()
    )


def test_load_params_rejects_missing_keys():
    bank = {"name": "fbank", "num_filts": 10, "sampling_rate": 8000}
    tc = STFTFrameComputer(
        dict(bank), frame_length_ms=25, precision="double", device="cpu"
    )
    params = dict(tc.params)
    del params["i8k_gmats"]
    with pytest.raises(ValueError):
        tc.load_params(params)


_PY = (
    "import sys, speech_tpu_torch, speech_tpu_torch.compute; "
    "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
    "or m == 'speech_tpu' or m.startswith('speech_tpu.')]; "
    "assert not bad, bad; print('clean')"
)


def test_import_pulls_in_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PY],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _port_sources():
    pkg = os.path.join(REPO, "speech_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "speech_tpu"):
                    bad.append((os.path.relpath(path, REPO), name))
    assert not bad, bad


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without a GPU, and in a directory holding nothing else of the repo,
    chip_smoke.py exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = [(REPO, os.path.join(REPO, "chip_smoke.py"))]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    runs.append((str(tmp_path), str(alone)))
    for cwd, script in runs:
        out = subprocess.run(
            [sys.executable, script],
            cwd=cwd,
            env=env,
            capture_output=True,
            text=True,
            timeout=120,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
