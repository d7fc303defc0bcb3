"""The port's library store (speech_tpu_torch.aot), against tests/test_aot.py.

The contract carries over from the JAX package: a warmed store builds
nothing.  Here an entry is a built shared library, so the store's own
cases build tiny C sources with g++; the CUDA kernels' path runs against a
stand-in ``nvcc`` (a script that builds a stub library with gcc and logs
each call), and the zero-build claims are held in subprocesses whose
``PATH`` has no compiler at all.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import wave

import numpy as np
import pytest
import torch

from speech_tpu_torch import aot
from speech_tpu_torch.aot import AOTCache, precompile_extractor
from speech_tpu_torch.compute import STFTFrameComputer
from speech_tpu_torch.ops import _build
from speech_tpu_torch.ops import stft_kernels as K
from speech_tpu_torch.parallel import ShardedExtractor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(ROOT, "tests", "audio")
CFG = {"name": "fbank", "num_filts": 12, "sampling_rate": 8000}
FLAGS = ("-O1", "-shared", "-fPIC")
STATS0 = {"hits": 0, "misses": 0, "errors": 0, "fallbacks": 0, "evicted": 0,
          "orphans_removed": 0}
GCC = shutil.which("gcc") or "/usr/bin/gcc"
GXX = shutil.which("g++") or "/usr/bin/g++"
REAL_PATH = os.environ["PATH"]  # the stand-in compilers' own tools


@pytest.fixture
def fresh(monkeypatch):
    """A fresh process's view: no library loaded yet."""
    monkeypatch.setattr(aot, "_LOADED", {})


def _entries(directory):
    """Stored library paths (under the per-toolchain subdirectories)."""
    found = []
    for root, _, files in os.walk(directory):
        found.extend(os.path.join(root, f) for f in files
                     if f.endswith(".so") and not f.startswith("."))
    return sorted(found)


def _source(tmp_path, value, name="tiny"):
    path = tmp_path / f"{name}_{value}.cpp"
    path.write_text(f'extern "C" int answer(void) {{ return {value}; }}\n')
    return path


def _load(cache, src, flags=FLAGS, capability=None):
    return cache.load_library("tiny", src, flags, "g++", capability)


def _no_compiler_env(tmp_path):
    """An environment in which no compiler is reachable."""
    empty = tmp_path / "empty_bin"
    empty.mkdir(exist_ok=True)
    return dict(os.environ, PATH=str(empty), CUDA_HOME=str(empty), PYTHONPATH=ROOT)


def _child(code, env, *args):
    proc = subprocess.run([sys.executable, "-W", "error", "-c", code, *map(str, args)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


# --- the store's own cases (tests/test_aot.py:54-591) ----------------------


def test_store_roundtrip_and_stats(tmp_path, fresh, monkeypatch):
    src = _source(tmp_path, 7)
    cache = AOTCache(str(tmp_path / "store"))
    assert _load(cache, src).answer() == 7
    assert cache.stats == {**STATS0, "misses": 1}
    assert set(cache.build_seconds) == {"tiny"}
    # a fresh process over the same directory: a pure hit
    monkeypatch.setattr(aot, "_LOADED", {})
    cache2 = AOTCache(str(tmp_path / "store"))
    assert _load(cache2, src).answer() == 7
    assert cache2.stats == {**STATS0, "hits": 1}
    assert len(_entries(tmp_path / "store")) == 1
    assert cache2.size_bytes() == os.path.getsize(_entries(tmp_path / "store")[0])


def test_key_changes_with_source_flags_and_capability(tmp_path, fresh):
    cache = AOTCache(str(tmp_path / "store"))
    a, b = _source(tmp_path, 1), _source(tmp_path, 2)
    assert _load(cache, a).answer() == 1
    assert _load(cache, b).answer() == 2
    _load(cache, a, flags=("-O2", "-shared", "-fPIC"))
    _load(cache, a, capability="sm_90")
    _load(cache, a, capability="sm_80")
    assert cache.stats["misses"] == 5 and cache.stats["hits"] == 0
    assert len(_entries(tmp_path / "store")) == 5
    keys = {aot.library_key(a.read_bytes(), FLAGS, cap) for cap in (None, "sm_80", "sm_90")}
    assert len(keys) == 3


def test_corrupt_entry_is_counted_rebuilt_and_repaired(tmp_path, fresh, monkeypatch):
    src = _source(tmp_path, 3)
    _load(AOTCache(str(tmp_path / "a")), src)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    (path,) = _entries(tmp_path / "b")
    with open(path, "wb") as f:
        f.write(b"not a shared library")
    monkeypatch.setattr(aot, "_LOADED", {})
    cache = AOTCache(str(tmp_path / "b"))
    assert _load(cache, src).answer() == 3
    assert cache.stats["errors"] == 1 and cache.stats["misses"] == 1
    # and the entry was repaired in place
    assert _entries(tmp_path / "b") == [path]
    monkeypatch.setattr(aot, "_LOADED", {})
    cache3 = AOTCache(str(tmp_path / "b"))
    assert _load(cache3, src).answer() == 3
    assert cache3.stats["hits"] == 1 and cache3.stats["errors"] == 0


def test_prune_evicts_lru_past_cap(tmp_path, fresh):
    cache = AOTCache(str(tmp_path / "store"))
    for value in (2, 3, 4, 5):
        _load(cache, _source(tmp_path, value))
    entries = _entries(tmp_path / "store")
    assert len(entries) == 4
    per = max(os.path.getsize(p) for p in entries)
    now = time.time()
    for age, p in enumerate(sorted(entries, key=os.path.getmtime)):
        os.utime(p, (now - 400 + age * 100, now - 400 + age * 100))
    ordered = sorted(entries, key=os.path.getmtime)
    res = cache.prune(max_bytes=2 * per + 1)
    assert res["evicted"] == 2 and cache.stats["evicted"] == 2 and res["kept"] == 2
    left = set(_entries(tmp_path / "store"))
    assert left == set(ordered[2:])  # newest two survive
    # a hit refreshes the LRU clock: touch the older survivor, cap to one
    old, _new = sorted(left, key=os.path.getmtime)
    os.utime(old, None)
    time.sleep(0.01)
    res = cache.prune(max_bytes=per + 1)
    assert res["evicted"] == 1
    assert set(_entries(tmp_path / "store")) == {old}


def test_prune_sweeps_stale_fingerprint_orphans(tmp_path, fresh):
    src = _source(tmp_path, 1)
    cache = AOTCache(str(tmp_path / "store"))
    _load(cache, src)
    stale = tmp_path / "store" / "fp-0123456789abcdef"
    stale.mkdir()
    (stale / "deadbeef.so").write_bytes(b"x" * 100)
    (stale / "junk.tmp").write_bytes(b"y")
    res = cache.prune()
    assert res["orphans_removed"] == 2 and res["kept"] == 1
    assert not stale.exists()
    cache2 = AOTCache(str(tmp_path / "store"))
    _load(cache2, src)
    assert cache2.stats["hits"] == 1


def test_max_bytes_autoprunes_on_write(tmp_path, fresh):
    cache = AOTCache(str(tmp_path / "store"), max_bytes=1)  # everything over cap
    for value in (2, 3, 4):
        assert _load(cache, _source(tmp_path, value)).answer() == value
    # each write prunes to the cap: at most one entry ever remains
    assert len(_entries(tmp_path / "store")) <= 1
    assert cache.stats["evicted"] >= 2


def test_world_writable_store_tightened_or_refused(tmp_path, monkeypatch, caplog):
    d = tmp_path / "store"
    d.mkdir()
    os.chmod(d, 0o777)
    AOTCache(str(d))
    assert (os.stat(d).st_mode & 0o077) == 0
    assert "tightened to 0700" in caplog.text
    os.chmod(d, 0o777)
    uid = os.getuid()
    monkeypatch.setattr(aot.os, "getuid", lambda: uid + 1)  # not ours
    with pytest.raises(ValueError, match="not owned by this user"):
        AOTCache(str(d))


def _fake_gxx(tmp_path, release):
    """A g++ that reports ``release`` and builds with the real one."""
    d = tmp_path / f"gxx_{release}"
    d.mkdir()
    script = d / "g++"
    script.write_text(
        "#!/bin/sh\n"
        f'if [ "$1" = "--version" ]; then echo "g++ (test) {release}"; exit 0; fi\n'
        f'export PATH={REAL_PATH}\n'
        f'exec {GXX} "$@"\n'
    )
    script.chmod(0o755)
    return str(d)


def test_fingerprint_toolkit_rule(tmp_path, fresh, monkeypatch):
    """Where the compiler is found, only its release's entries serve (an
    upgrade rebuilds and prune sweeps the old one); where it is not, any
    release's entry of the same key serves, and prune keeps it."""
    src = _source(tmp_path, 9)
    store = str(tmp_path / "store")
    monkeypatch.setenv("PATH", _fake_gxx(tmp_path, "1.0"))
    c1 = AOTCache(store)
    _load(c1, src)
    assert c1.stats["misses"] == 1
    monkeypatch.setattr(aot, "_LOADED", {})
    monkeypatch.setenv("PATH", _fake_gxx(tmp_path, "2.0"))  # the upgrade
    c2 = AOTCache(store)
    assert _load(c2, src).answer() == 9
    assert c2.stats["misses"] == 1 and c2.stats["hits"] == 0
    assert len(_entries(store)) == 2
    res = c2.prune()
    assert res["orphans_removed"] == 1 and res["kept"] == 1
    (kept,) = _entries(store)
    with open(os.path.join(os.path.dirname(kept), "TOOLCHAIN")) as f:
        assert "2.0" in f.read()
    # a runtime-only machine: no g++ at all
    monkeypatch.setattr(aot, "_LOADED", {})
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    assert aot.find_compiler("g++") is None
    c3 = AOTCache(store)
    assert _load(c3, src).answer() == 9
    assert c3.stats == {**STATS0, "hits": 1}
    assert c3.prune()["orphans_removed"] == 0 and _entries(store) == [kept]
    # and with no entry to serve, the error names the store and compiler
    with pytest.raises(RuntimeError, match=r"(?s)store.*g\+\+ is not found"):
        _load(c3, _source(tmp_path, 10))


def test_explain_logs_hits_and_misses(tmp_path, fresh, caplog):
    cache = AOTCache(str(tmp_path / "store"))
    cache.explain = True
    src = _source(tmp_path, 4)
    _load(cache, src)
    _load(AOTCache(str(tmp_path / "store2")), src)  # not explained
    cache2 = AOTCache(str(tmp_path / "store"))
    cache2.explain = True
    _load(cache2, src)
    text = caplog.text
    assert "AOT miss: tiny (built in" in text and "capability none" in text
    assert "AOT hit: tiny" in text
    assert text.count("AOT miss") == 1


# --- the shorten decoder through a store ------------------------------------

SHN = sorted(
    os.path.join(AUDIO, f) for f in os.listdir(AUDIO) if f.endswith("_shn.sph")
)

_SHORTEN_CHILD = """
import sys
import numpy as np
from speech_tpu_torch import aot
from speech_tpu_torch.io import _native, read_signal
assert aot.find_compiler("g++") is None and aot.find_compiler("nvcc") is None
store = aot.AOTCache(sys.argv[1])
with aot.using(store):
    assert _native.get_shorten_lib() is not None
    out = {str(i): read_signal(p) for i, p in enumerate(sys.argv[3:])}
np.savez(sys.argv[2], **out)
print(store.stats)
assert store.stats["misses"] == 0 and store.stats["errors"] == 0
assert store.stats["hits"] == 1
"""


def test_warm_store_serves_shorten_without_a_compiler(tmp_path, monkeypatch):
    from speech_tpu_torch.io import _native
    import speech_tpu_torch.io as TIO

    store = AOTCache(str(tmp_path / "store"))
    assert _native.get_shorten_lib(store) is not None
    assert store.stats["misses"] == 1 and len(_entries(store.directory)) == 1
    out = tmp_path / "decoded.npz"
    _child(_SHORTEN_CHILD, _no_compiler_env(tmp_path), store.directory, out, *SHN)
    got = np.load(out)
    monkeypatch.setattr(_native, "get_shorten_lib", lambda: None)  # the Python decoder
    for i, path in enumerate(SHN):
        want = TIO.read_signal(path)
        assert got[str(i)].dtype == want.dtype and np.array_equal(got[str(i)], want), path


# --- the CUDA kernels' libraries, with a stand-in nvcc -----------------------

_STUB = 'const char *stk_error_string(int c) { return "stub"; }\n' + "".join(
    f"int {name}(void) {{ return 0; }}\n" for name in K._LIBRARIES
)


@pytest.fixture
def stand_in_nvcc(tmp_path, monkeypatch):
    """``nvcc`` on PATH, a script that logs each build and makes a stub
    library with gcc; returns its log."""
    d = tmp_path / "cuda_bin"
    d.mkdir()
    stub = d / "stub.c"
    stub.write_text(_STUB)
    log = d / "calls.log"
    script = d / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import os, subprocess, sys\n"
        "args = sys.argv[1:]\n"
        "if args == ['--version']:\n"
        "    print('Cuda compilation tools, release 0.0, V0.0.0'); sys.exit(0)\n"
        f"open({str(log)!r}, 'a').write(args[-1] + '\\n')\n"
        "out = args[args.index('-o') + 1]\n"
        f"sys.exit(subprocess.call([{GCC!r}, '-shared', '-fPIC', '-o', out, {str(stub)!r}],\n"
        f"                         env=dict(os.environ, PATH={REAL_PATH!r})))\n"
    )
    script.chmod(0o755)
    monkeypatch.setenv("PATH", str(d))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(aot, "_LOADED", {})
    yield log
    K._bound.cache_clear()


def _calls(log):
    return log.read_text().split() if log.exists() else []


_KERNELS_CHILD = """
import sys
from speech_tpu_torch import aot
from speech_tpu_torch.ops import _build
assert aot.find_compiler("nvcc") is None
store = aot.AOTCache(sys.argv[1])
libs = _build.load_kernels(store)
assert sorted(libs) == ["double_kernels", "int8_kernels", "layout_kernels", "stft_kernels"], \
    sorted(libs)
assert libs["int8_kernels"].stk_error_string and libs["layout_kernels"].stk_layout_rows
assert store.stats["misses"] == 0 and store.stats["errors"] == 0, store.stats
assert store.stats["hits"] == 4, store.stats
"""


def test_load_kernels_builds_each_source_once(tmp_path, stand_in_nvcc, monkeypatch):
    log = stand_in_nvcc
    sources = sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    store = AOTCache(str(tmp_path / "store"))
    libs = _build.load_kernels(store)
    assert sorted(_calls(log)) == sources  # one nvcc per .cu, cold
    assert len(sources) == 4 and store.stats["misses"] == 4
    assert set(store.build_seconds) == set(libs)
    assert _build.load_kernels(store) is libs  # asked once a process
    monkeypatch.setattr(aot, "_LOADED", {})
    warm = AOTCache(store.directory)
    _build.load_kernels(warm)
    assert warm.stats["hits"] == 4 and warm.stats["misses"] == 0
    assert len(_calls(log)) == 4  # none on a warmed store
    # nor in a process with no nvcc at all
    _child(_KERNELS_CHILD, _no_compiler_env(tmp_path), store.directory)
    assert len(_calls(log)) == 4
    # the card's capability is part of the key
    monkeypatch.setattr(aot, "device_capability", lambda: "sm_90")
    other = AOTCache(store.directory)
    _build.load_kernels(other)
    assert len(_calls(log)) == 8 and other.stats["misses"] == 4
    assert len(_entries(store.directory)) == 8


def test_enable_aot_after_a_first_load_completes_the_store(tmp_path, stand_in_nvcc):
    """A library loaded before ``enable_aot`` is copied into the store at
    the next launch, never loaded twice: the port's
    tests/test_aot.py::test_enable_aot_invalidates_prewired_programs."""
    log = stand_in_nvcc
    first = _build.load_kernels(AOTCache(str(tmp_path / "before")))
    computer = STFTFrameComputer(dict(CFG), frame_length_ms=25, frame_shift_ms=10,
                                 precision="double", device="cpu")
    computer.enable_aot(str(tmp_path / "after"))
    with aot.using(computer._aot):
        fn, _ = K._launcher("stk_int8_feats")
    assert len(_calls(log)) == 4  # no second build
    assert computer._aot.stats["misses"] == 4 and computer._aot.stats["hits"] == 0
    assert len(_entries(tmp_path / "after")) == 4
    assert fn is getattr(first["int8_kernels"], "stk_int8_feats")
    # outside the block, the wrappers read the process default again
    assert aot.active_store() is aot.default_store()


# --- the wiring ---------------------------------------------------------------


def _computer(**kw):
    return STFTFrameComputer(dict(CFG), frame_length_ms=25, frame_shift_ms=10,
                             device="cpu", **kw)


@pytest.mark.parametrize("shared", [False, True], ids=["path", "cache"])
def test_serving_objects_take_a_path_or_a_shared_cache(tmp_path, shared):
    from speech_tpu_torch.serve import FeatureServer, StreamPool, StreamServer

    store = str(tmp_path / "store")
    cache = AOTCache(store) if shared else None
    arg = cache if shared else store
    rng = np.random.RandomState(12)
    signals = [rng.randn(n).astype(np.float32) for n in (900, 1500, 2800, 2048)]

    want = ShardedExtractor(_computer(precision="double")).extract(signals, min_batch=4)
    comp = _computer(precision="double")
    ex = ShardedExtractor(comp, aot_dir=arg)
    assert isinstance(ex.aot, AOTCache) and ex.aot.directory == store
    assert comp._aot is ex.aot and (not shared or ex.aot is cache)
    for a, b in zip(want, ex.extract(signals, min_batch=4)):
        assert np.array_equal(a, b)

    with FeatureServer(_computer(), max_batch=4, aot_dir=arg) as server:
        assert not shared or server._extractor.aot is cache
        got = server.extract(signals[1])
    assert np.array_equal(got, _computer().compute_full(signals[1]))

    pool = StreamPool(_computer(), slots=2, chunk_size=800, aot_dir=arg)
    assert pool.aot.directory == store and (not shared or pool.aot is cache)
    h = pool.open()
    pool.feed(h, signals[2])
    rows = [f for hh, f in pool.step(max_chunks=8) if hh == h]
    rows += [f for hh, f in pool.close(h) if hh == h]
    streamed = np.concatenate([np.asarray(r) for r in rows if len(r)], axis=0)
    plain = StreamPool(_computer(), slots=2, chunk_size=800)
    h = plain.open()
    plain.feed(h, signals[2])
    ref = [f for hh, f in plain.step(max_chunks=8) if hh == h]
    ref += [f for hh, f in plain.close(h) if hh == h]
    assert np.array_equal(streamed, np.concatenate([np.asarray(r) for r in ref if len(r)]))

    with StreamServer(_computer(), slots=2, chunk_size=800, aot_dir=arg) as server:
        assert server._pool.aot.directory == store
    # the CPU routes and the stream ticks launch no kernel: nothing stored
    assert _entries(store) == []
    if shared:
        assert cache.stats == STATS0


def test_precompile_extractor_grid(tmp_path):
    ex = ShardedExtractor(_computer(), aot_dir=str(tmp_path / "store"))
    seen = []
    n = precompile_extractor(ex, [1000, 1700, 3000], batches=[3, 4],
                             dtypes=[np.float32, np.int16], progress=seen.append)
    # buckets {1024, 2048, 4096} x batches {3, 4} x 2 dtypes, two routes each
    assert n == 24 and len(seen) == 12
    assert seen[0] == "precompile bucket=1024 batch=3 dtype=float32"


def test_precompile_stores_the_layout_kernel_and_prune_keeps_it(tmp_path, stand_in_nvcc,
                                                                 capsys):
    """Where batches cross packed (a GPU), ``--precompile``'s grid stores
    the layout kernel's library whatever route the computer takes (here
    the plain one, which loads no library), and ``--aot-prune`` keeps it."""
    import speech_tpu_torch.command_line as tcli

    store = str(tmp_path / "store")
    ex = ShardedExtractor(_computer(), aot_dir=store)
    assert precompile_extractor(ex, [1000], batches=[2]) == 2
    assert _entries(store) == []  # the CPU routes load no library
    ex._packs = True
    assert precompile_extractor(ex, [1000], batches=[2]) == 2
    names = sorted(os.path.basename(p).split("-")[0] for p in _entries(store))
    assert names == ["double_kernels", "int8_kernels", "layout_kernels", "stft_kernels"]
    assert ex.aot.stats["misses"] == 4
    stale = tmp_path / "store" / "fp-feedfacefeedface"
    stale.mkdir()
    (stale / "old.so").write_bytes(b"x")
    rc = tcli.signals_to_torch_feat_dir(
        [_corpus(tmp_path), _cli_config(device="cpu"), str(tmp_path / "out"),
         "--aot-dir", store, "--aot-prune"])
    assert rc == 0
    assert "1 orphan(s) swept, 0 evicted, 4 kept" in capsys.readouterr().out
    kept = sorted(os.path.basename(p).split("-")[0] for p in _entries(store))
    assert kept == names


# --- the CLIs -------------------------------------------------------------------


def _corpus(tmp_path, n=5, seed=6):
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.RandomState(seed)
    map_path = tmp_path / "map.txt"
    with open(map_path, "w") as mf:
        for i in range(n):
            sig = (rng.randn(rng.randint(800, 2400)) * 3000).astype(np.int16)
            path = str(wav_dir / f"utt{i}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(8000)
                w.writeframes(sig.tobytes())
            mf.write(f"utt{i} {path}\n")
    return str(map_path)


def _cli_config(**kw):
    return json.dumps({"name": "stft", "bank": CFG, "frame_length_ms": 25,
                       "frame_shift_ms": 10, **kw})


_CLI_CHILD = """
import sys
from speech_tpu_torch import aot
from speech_tpu_torch.command_line import signals_to_torch_feat_dir
assert aot.find_compiler("g++") is None and aot.find_compiler("nvcc") is None
sys.exit(signals_to_torch_feat_dir(sys.argv[1:]))
"""


def test_cli_precompile_then_run_without_compilers(tmp_path, capsys):
    import speech_tpu.command_line as jcli
    import speech_tpu_torch.command_line as tcli

    map_path = _corpus(tmp_path)
    store = str(tmp_path / "aot")
    cfg = _cli_config(device="cpu", precision="double")
    base = [map_path, cfg, str(tmp_path / "feats"), "--batch-size", "4", "--aot-dir", store]
    assert tcli.signals_to_torch_feat_dir(base + ["--precompile"]) == 0
    err = capsys.readouterr().err
    assert f"program grid points into {store} (compiled 0, already stored 0)" in err
    assert not os.listdir(tmp_path / "feats")
    # the JAX command walks the same grid
    jbase = [map_path, _cli_config(), str(tmp_path / "jfeats"), "--batch-size", "4",
             "--aot-dir", str(tmp_path / "jaot"), "--precompile"]
    assert jcli.signals_to_torch_feat_dir(jbase) == 0
    jerr = capsys.readouterr().err

    def grid(text):
        # the JAX command rounds the batch up to its 8-device CPU mesh
        return [[w for w in line.split() if not w.startswith("batch=")]
                for line in text.splitlines() if line.startswith("precompile ")]

    assert grid(err) == grid(jerr) and len(grid(err)) > 0
    assert err.split("precompiled ")[1].split(" program")[0] == \
        jerr.split("precompiled ")[1].split(" program")[0]
    # the run itself, in a process with no compiler reachable
    _child(_CLI_CHILD, _no_compiler_env(tmp_path), *base)
    assert tcli.signals_to_torch_feat_dir(
        [map_path, cfg, str(tmp_path / "plain"), "--batch-size", "4"]) == 0
    names = sorted(os.listdir(tmp_path / "plain"))
    assert sorted(os.listdir(tmp_path / "feats")) == names and len(names) == 5
    for name in names:
        assert torch.equal(torch.load(str(tmp_path / "feats" / name)),
                           torch.load(str(tmp_path / "plain" / name)))


def test_cli_precompile_requires_aot_dir(tmp_path, capsys):
    import speech_tpu_torch.command_line as tcli

    rc = tcli.signals_to_torch_feat_dir(
        [_corpus(tmp_path), _cli_config(device="cpu"), str(tmp_path / "out"),
         "--batch-size", "2", "--precompile"])
    assert rc == 1
    assert "--precompile requires --aot-dir" in capsys.readouterr().err


@pytest.mark.parametrize("command", [
    "signals_to_torch_feat_dir", "compute_feats_from_kaldi_tables", "torch_feat_dir_to_signals",
])
def test_cli_aot_prune(command, tmp_path, fresh, capsys):
    """--aot-prune sweeps orphans and exits 0 without feature work."""
    import speech_tpu_torch.command_line as tcli

    cache = AOTCache(str(tmp_path / "store"))
    _load(cache, _source(tmp_path, 1))
    stale = tmp_path / "store" / "fp-feedfacefeedface"
    stale.mkdir()
    (stale / "old.so").write_bytes(b"x")
    cfg = _cli_config(device="cpu")
    out = str(tmp_path / "out")
    positional = {
        "signals_to_torch_feat_dir": [_corpus(tmp_path), cfg, out],
        "compute_feats_from_kaldi_tables": ["scp:" + str(tmp_path / "none.scp"), "ark:" + out, cfg],
        "torch_feat_dir_to_signals": [str(tmp_path), cfg, out],
    }[command]
    rc = getattr(tcli, command)(positional + ["--aot-dir", str(tmp_path / "store"), "--aot-prune"])
    assert rc == 0
    assert "aot store pruned: 1 orphan(s) swept, 0 evicted, 1 kept" in capsys.readouterr().out
    assert not stale.exists() and len(_entries(tmp_path / "store")) == 1
    assert not os.path.exists(out)


def test_cli_aot_max_bytes(tmp_path, fresh, capsys):
    import speech_tpu_torch.command_line as tcli

    cache = AOTCache(str(tmp_path / "store"))
    for value in (1, 2):
        _load(cache, _source(tmp_path, value))
    per = max(os.path.getsize(p) for p in _entries(tmp_path / "store"))
    rc = tcli.signals_to_torch_feat_dir(
        [_corpus(tmp_path), _cli_config(device="cpu"), str(tmp_path / "out"),
         "--aot-dir", str(tmp_path / "store"), "--aot-max-bytes", str(per + 1), "--aot-prune"])
    assert rc == 0
    assert "0 orphan(s) swept, 1 evicted, 1 kept" in capsys.readouterr().out
    assert len(_entries(tmp_path / "store")) == 1


def test_cli_precompile_sizes_from_headers(tmp_path, monkeypatch):
    """The grid comes from container headers: read_signal never runs."""
    import speech_tpu_torch.command_line as tcli

    def boom(*a, **k):
        raise AssertionError("read_signal called during the --precompile header scan")

    monkeypatch.setattr(tcli, "read_signal", boom)
    rc = tcli.signals_to_torch_feat_dir(
        [_corpus(tmp_path, n=3), _cli_config(device="cpu"), str(tmp_path / "out"),
         "--batch-size", "2", "--aot-dir", str(tmp_path / "aot"), "--precompile",
         "--pitch", "{}"])
    assert rc == 0
