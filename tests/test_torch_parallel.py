"""speech_tpu_torch.parallel against speech_tpu.parallel, on the CPU.

The port runs at world sizes 1, 2 and 4 over gloo: world 1 in this process
(a process group at a ``FileStore`` under ``tmp_path``, destroyed as soon as
its cases have run), worlds 2 and 4 as one launch each of
``tests/torch_dist_worker.py`` (one process a rank, every case in one run).
The inputs are the same at every world size (spans and batches divide by
4).  The JAX package runs them once unsharded and once on its CPU mesh cut
to 4 devices (a JAX mesh program compiles for seconds, so each is computed
once and held against all three worlds; JAX's own tests hold its sharded
and unsharded results equal), except pitch, whose JAX shard map takes
about 20 s to compile here: the port's sharded pitch is held against JAX's
unsharded ``pitch_feats``.  Tolerances: halo framing, int16 ingress
and frame counts bitwise; sharded STFT and the extractor within 1e-8
(float64); sharded SI within 1e-9; statistics within rtol 1e-12; pitch
within 1e-4 with equal valid counts.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch.distributed as dist

import speech_tpu
from speech_tpu import parallel as jpar
from speech_tpu.ops import framing as jframing
from speech_tpu.ops.pitch import pitch_feats as jpitch_feats

import speech_tpu_torch
from speech_tpu_torch import parallel as tpar
from speech_tpu_torch.parallel import multihost

import torch_dist_worker as W

WORLDS = (1, 2, 4)
TOL = 1e-8
TOL_SI = 1e-9
TOL_PITCH = 1e-4
RTOL_STATS = 1e-12


def _in_process(tmp, fn):
    """``fn()`` inside a world-size-1 gloo group, destroyed after."""
    multihost.initialize(
        store=dist.FileStore(os.path.join(tmp, "store1"), 1),
        num_processes=1, process_id=0, backend="gloo",
    )
    try:
        return fn()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's results by world size."""
    tmp = str(tmp_path_factory.mktemp("torch_dist"))
    launches = {w: W.launch(w, tmp) for w in (2, 4)}
    try:
        results = {1: _in_process(tmp, lambda: W.run_cases(1))}
    finally:
        launched = {w: W.wait(*launches[w]) for w in launches}
    return {**results, **launched}


JAX_WORLD = 4


@pytest.fixture(scope="module")
def x():
    return W.inputs()


def _mesh(world=JAX_WORLD):
    return jpar.make_mesh(("data",), devices=jax.devices()[:world])


def _jax_stft():
    return W.stft_computer(speech_tpu)


def _ragged(r, prefix):
    return np.split(r[prefix], np.cumsum(r[prefix + "_n"])[:-1])


def _close_lists(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax(case: str, sharded: bool):
    """The JAX package's result for ``case`` on the inputs, on the 4-device
    mesh or unsharded; computed once."""
    x = W.inputs()
    mesh = _mesh() if sharded else None
    c = _jax_stft()
    fl, fs = c.frame_length, c.frame_shift
    if case.startswith("halo_"):
        style = case[5:]
        pad_left = jframing.left_pad_width(style, fl, fs, False)
        sig = jnp.asarray(x["halo_signal"])
        if sharded:
            return np.asarray(jpar.halo_frame_signal(sig, mesh, "data", fl, fs, pad_left))
        return np.asarray(jframing.frame_signal(sig, sig.size, sig.size // fs, fl, fs, pad_left))
    if case == "stft":
        sig = x["stft_signal"]
        if sharded:
            return np.asarray(jpar.sharded_stft_feats(c, jnp.asarray(sig), mesh, "data"))
        return c.compute_full(sig)
    if case.startswith("si_") and case != "si_extract":
        _, style, energy = case.split("_")
        sc = W.si_computer(speech_tpu, style, bool(int(energy)))
        sig = x["si_signal"]
        if sharded:
            return np.asarray(jpar.sharded_si_feats(sc, jnp.asarray(sig), mesh, "data"))
        return sc.compute_full(sig)
    if case in ("full", "traced"):
        ex = jpar.ShardedExtractor(c, mesh)
        lengths = np.full(x["full_batch"].shape[0], x["full_batch"].shape[1])
        lengths = lengths if case == "full" else jnp.asarray(lengths)
        feats, counts = ex.extract_batch(x["full_batch"], lengths)
        assert case == "traced" or any(k[2] for k in ex._fns)  # its static path
        return np.asarray(feats), np.asarray(counts)
    if case == "mh":  # the corpus as one batch with its lengths
        ex = jpar.ShardedExtractor(c, mesh)
        feats, counts = ex.extract_batch(x["corpus"], jnp.asarray(x["corpus_lengths"]))
        return np.asarray(feats), np.asarray(counts)
    if case == "stats":
        if sharded:
            return np.asarray(jpar.accumulate_stats_sharded(x["stats_feats"], x["stats_counts"], mesh))
        return np.asarray(jpar.accumulate_stats(x["stats_feats"], x["stats_counts"]))
    if case == "pitch":
        feats, valid = jpitch_feats(x["pitch"], W.PITCH_RATE, lengths=x["pitch_lengths"],
                                    return_valid=True)
        return np.asarray(feats), np.asarray(valid)
    # lists of utterances through the extractor
    if case == "fine":
        return jpar.ShardedExtractor(c, mesh, bucket="fine").extract(x["fine"])
    if case.startswith("iter"):
        outs = list(jpar.ShardedExtractor(c, mesh).extract_iter(iter(x["iter"])))
        return outs[int(case[4:])]
    if case == "post":
        ex = jpar.ShardedExtractor(c, mesh, postprocessors=W.post_chain(speech_tpu))
        return ex.extract(x["post"])
    if case == "si_extract":
        ex = jpar.ShardedExtractor(W.si_computer(speech_tpu, "centered", True), mesh)
        return ex.extract(x["si_ragged"])
    return jpar.ShardedExtractor(c, mesh).extract(x[case])  # ragged, int16


# --- mesh -------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shapes(port, world):
    r = port[world]
    assert int(r["mesh_data"]) == world == _mesh(world).shape["data"]
    assert int(r["mesh_error"]) == 1
    if world % 2 == 0:
        want = jpar.make_mesh(("data", "filt"), shape=(-1, 2), devices=jax.devices()[:world])
        assert tuple(r["mesh_2d"]) == (want.shape["data"], want.shape["filt"])
        assert list(r["placements"]) == ["Replicate()", "Shard(dim=1)", "Shard(dim=0)", "Replicate()"]


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tpar.make_mesh(("data",), devices="cpu")


def test_multihost_initialize_without_launcher_is_a_no_op(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.process_slice(10) == slice(0, 10)


def test_initialize_is_idempotent(tmp_path):
    def twice():
        multihost.initialize(store=dist.FileStore(str(tmp_path / "again"), 1),
                             num_processes=1, process_id=0, backend="gloo")
        return dist.get_world_size()

    assert _in_process(str(tmp_path), twice) == 1
    assert not dist.is_initialized()


# --- halo paths -------------------------------------------------------------


@pytest.mark.parametrize("style", ["causal", "centered"])
@pytest.mark.parametrize("world", WORLDS)
def test_halo_framing_bitwise(port, world, style):
    got = port[world][f"halo_{style}"]
    assert np.array_equal(got, _jax(f"halo_{style}", False))
    if style == "centered":  # the global-edge reflections
        assert np.array_equal(got, _jax(f"halo_{style}", True))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stft_feats(port, world):
    got = port[world]["stft"]
    for sharded in (False, True):
        want = _jax("stft", sharded)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert int(port[world]["halo_error"]) == 1


@pytest.mark.parametrize("style,energy", W.SI_VARIANTS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_si_feats(port, x, world, style, energy):
    case = f"si_{style}_{int(energy)}"
    got = port[world][case]
    sc = W.si_computer(speech_tpu, style, energy)
    assert got.shape == (x["si_signal"].size // sc.frame_shift, sc.num_coeffs)
    full = _jax(case, False)
    np.testing.assert_allclose(got[: full.shape[0]], full, rtol=0, atol=TOL_SI)
    if style == "centered" and energy:
        np.testing.assert_allclose(got, _jax(case, True), rtol=0, atol=TOL_SI)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_si_feats_validates_span(port, world):
    assert int(port[world]["si_error"]) == 1


# --- the extractor ----------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_extractor_ragged(port, world):
    got = _ragged(port[world], "ragged")
    _close_lists(got, _jax("ragged", False), TOL)
    _close_lists(got, _jax("ragged", True), TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_extractor_static_fast_path_and_traced(port, world):
    r = port[world]
    for name in ("full", "traced"):
        feats, counts = _jax(name, True)
        assert np.array_equal(r[f"{name}_counts"], counts)
        np.testing.assert_allclose(r[f"{name}_feats"], feats, rtol=0, atol=TOL)
    np.testing.assert_allclose(r["full_feats"], r["traced_feats"], rtol=0, atol=1e-10)
    assert int(r["batch_error"]) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_extractor_int16_ingress(port, world):
    r = port[world]
    assert bool(r["int16_equal"])
    _close_lists(_ragged(r, "int16"), _jax("int16", False), TOL)
    assert len(r["mixed_n"]) == 2


def test_fine_bucket_lengths():
    """'fine' buckets hit {2^k, 3*2^(k-1)}, never shrink a signal, and are
    the JAX package's at every length."""
    tc = W.stft_computer(speech_tpu_torch)
    jc = _jax_stft()
    fl = tc.frame_length
    for bucket in ("pow2", "fine"):
        tex = tpar.ShardedExtractor(tc, bucket=bucket)
        jex = jpar.ShardedExtractor(jc, bucket=bucket)
        for n in (1, fl, 1000, 1024, 1025, 1536, 1537, 2047, 2048, 100000):
            assert tex.bucket_len(n) == jex.bucket_len(n) >= max(n, fl)
    assert tpar.ShardedExtractor(tc, bucket="fine").bucket_len(1025) == 1536
    with pytest.raises(ValueError):
        tpar.ShardedExtractor(tc, bucket="powers-of-ten")


@pytest.mark.parametrize("world", WORLDS)
def test_extractor_fine_buckets(port, world):
    _close_lists(_ragged(port[world], "fine"), _jax("fine", False), TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_extract_iter_double_buffered(port, world):
    for i in range(3):
        _close_lists(_ragged(port[world], f"iter{i}"), _jax(f"iter{i}", False), TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_extractor_postprocessors(port, world):
    _close_lists(_ragged(port[world], "post"), _jax("post", False), TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_extractor_si(port, world):
    _close_lists(_ragged(port[world], "si_extract"), _jax("si_extract", False), TOL_SI)


def test_extract_iter_timer_stages():
    """``timer=`` sees every batch's dispatch and collect, each with the
    stages nested in it."""
    import contextlib

    seen = []

    class Timer:
        @contextlib.contextmanager
        def stage(self, name):
            seen.append(name)
            yield

    ex = tpar.ShardedExtractor(W.stft_computer(speech_tpu_torch))
    rng = np.random.RandomState(3)
    batches = [[rng.randn(900)] for _ in range(3)]
    outs = list(ex.extract_iter(batches, timer=Timer()))
    assert len(outs) == 3
    assert seen == ["dispatch", "pad", "launch", "dispatch", "pad", "launch", "collect", "wait",
                    "unpack", "dispatch", "pad", "launch", "collect", "wait", "unpack",
                    "collect", "wait", "unpack"]


# --- statistics, pitch, the multi-process data path -------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_accumulate_stats_sharded(port, x, world):
    want = _jax("stats", True)
    np.testing.assert_allclose(port[world]["stats"], want, rtol=RTOL_STATS, atol=0)
    np.testing.assert_allclose(port[world]["stats_onto"], 2 * want, rtol=RTOL_STATS, atol=0)
    local = tpar.accumulate_stats(x["stats_feats"], x["stats_counts"]).numpy()
    np.testing.assert_allclose(local, _jax("stats", False), rtol=RTOL_STATS, atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pitch_feats(port, world):
    r = port[world]
    feats, valid = _jax("pitch", False)
    assert np.array_equal(r["pitch_valid"], valid)
    np.testing.assert_allclose(r["pitch"], feats, rtol=0, atol=TOL_PITCH)
    if world > 1:
        assert int(r["pitch_error"]) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_global_batch(port, x, world):
    """Each rank feeds only its ``process_slice`` rows through
    ``global_batch_from_host_local``; one extractor batch and the sharded
    statistics equal the single-process computation."""
    r = port[world]
    assert tuple(r["slice"]) == (0, 8 // world)
    assert tuple(r["global_shape"]) == x["corpus"].shape
    feats, counts = _jax("mh", False)
    assert np.array_equal(r["mh_counts"], counts)
    stats = None
    for i, n in enumerate(counts):
        np.testing.assert_allclose(r["mh_feats"][i, :n], feats[i, :n], rtol=0, atol=1e-10)
        stats = jpar.accumulate_stats(feats[i, :n][None], stats=stats)
    np.testing.assert_allclose(r["mh_stats"], np.asarray(stats), rtol=RTOL_STATS, atol=0)
