"""Content-addressed store of built kernel libraries (cold-start elimination).

The counterpart of :mod:`speech_tpu.aot`, with its contract: *a warmed
store compiles nothing*.  In the JAX package an entry is a serialized XLA
executable; here nothing is compiled at run time but the native libraries,
so an entry is one built shared library: ``stft_kernels``,
``int8_kernels``, ``double_kernels`` or ``layout_kernels`` (``csrc/*.cu``,
nvcc, sm_90a) or ``shorten`` (``csrc/shorten.cpp``, g++).  A process on a
fresh machine (or a fresh container) that finds its libraries in the store
loads them and runs without a compiler.

- **Key.** ``sha256(source bytes || flags || compute capability)``: the
  card's ``torch.cuda.get_device_capability`` for a CUDA library,
  ``none`` for the host-only g++ library.  An edited source or changed
  flags can never load a stale library.
- **Fingerprint.** Entries live under ``fp-<hash>/``, one directory per
  toolchain that built them: the compiler's name, the line of its
  ``--version`` that names its release, and the machine.  Each directory's
  ``TOOLCHAIN`` file records it.  The toolkit rule: where the compiler is
  found, only its own toolchain's directory serves, so a toolkit upgrade
  rebuilds and :meth:`AOTCache.prune` sweeps the old directory as an
  orphan.  Where it is not found (a runtime-only machine, the case the
  store exists for), a lookup accepts an entry of the same key under any
  toolchain of that compiler, the newest first, and ``prune`` keeps those
  directories.  A directory without a ``TOOLCHAIN`` record is an orphan.
- **One load a process.** A library is loaded once per process, by key.
  A store that lacks a library this process already loaded from another
  path receives a copy of its file (a ``miss``), never a second
  ``dlopen``: a computer that ran a kernel before
  ``FrameComputer.enable_aot`` still leaves a complete store.
- **Lifecycle.** As the JAX package's: atomic writes (tempfile +
  ``os.replace``), LRU eviction past ``max_bytes`` (hits ``os.utime``
  their entry, so the order survives ``noatime`` mounts), an automatic
  prune after each write when ``max_bytes`` is set, and the orphan sweep.
  CLI: ``--aot-dir``, ``--aot-max-bytes``, ``--precompile``,
  ``--aot-prune``.
- **Trust boundary.** Loading a library runs its code, as unpickling does:
  anyone who can write to the store can run code in every process that
  reads it.  The directory is created mode ``0o700``; a group- or
  other-writable one that we own is tightened (with a warning) and one
  that we do not own is refused.
- **Corrupt entries.** An entry that ``ctypes.CDLL`` refuses counts in
  ``errors`` and is rebuilt in place.  Where the compiler is missing, the
  lookup raises, naming the store and the compiler: no plain fallback.

``wrap`` and the JAX package's ``_AOTFunction`` have no counterpart: eager
PyTorch code lowers no program, so there is nothing to key but the
libraries.  ``stats["fallbacks"]`` stays 0 and is kept so that a caller's
checks read the same in both packages.

Wiring: ``ShardedExtractor(..., aot_dir=...)``, ``FeatureServer``,
``StreamPool``/``StreamServer``, ``FrameComputer.enable_aot`` and the
CLIs' flags all take a path *or* an :class:`AOTCache`, so serving objects
can share one store and one stats block.  Kernel wrappers take their
libraries from :func:`active_store`: the store of the computer running
them (:func:`using`), else the process default (``build/speech_tpu_torch``
at the root of the checkout, or where
:func:`speech_tpu_torch.utils.enable_persistent_compilation_cache` moved
it).
"""

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import logging
import os
import platform
import shutil
import stat as _stat
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "AOTCache",
    "Library",
    "active_store",
    "as_cache",
    "default_store",
    "find_compiler",
    "precompile_extractor",
    "set_default_store",
    "using",
]

logger = logging.getLogger(__name__)

#: the process default store's directory: ``build/speech_tpu_torch`` at the
#: root of the checkout
DEFAULT_DIR = Path(__file__).resolve().parents[1] / "build" / "speech_tpu_torch"
_TOOLCHAIN_FILE = "TOOLCHAIN"
_BUILD_TIMEOUT_S = 900


class Library(NamedTuple):
    """One library of the store: ``name`` (its entries' file prefix), the
    ``source`` file, the compiler's ``flags``, the ``compiler``'s command
    name (``"nvcc"`` or ``"g++"``) and the card's ``capability``
    (``"sm_90"``; None for a host library)."""

    name: str
    source: Path
    flags: Tuple[str, ...]
    compiler: str
    capability: Optional[str] = None


def as_cache(store: Union[str, os.PathLike, "AOTCache", None]):
    """Normalize an ``aot_dir`` argument: path -> :class:`AOTCache`,
    cache -> itself, None -> None.  The shared entry point for every
    ``aot_dir=`` parameter in the package."""
    if store is None or isinstance(store, AOTCache):
        return store
    return AOTCache(store)


def find_compiler(compiler: str) -> Optional[str]:
    """The path of ``compiler`` (on ``PATH``; nvcc also under
    ``$CUDA_HOME/bin``, by default ``/usr/local/cuda``), or None."""
    found = shutil.which(compiler)
    if found:
        return found
    if compiler == "nvcc":
        default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if default.is_file():
            return str(default)
    return None


@functools.lru_cache(maxsize=None)
def _release(path: str) -> str:
    """The line of ``path --version`` that names the compiler's release
    (nvcc prints it last, g++ first)."""
    out = subprocess.run(
        [path, "--version"], capture_output=True, text=True, timeout=60
    ).stdout
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    for line in lines:
        if "release" in line.lower():
            return line
    return lines[0] if lines else "?"


def _toolchain(compiler: str, path: str) -> str:
    return f"{compiler}\n{_release(path)}\n{platform.machine()}"


def device_capability() -> Optional[str]:
    """``"sm_<major><minor>"`` of the current CUDA device; None without
    one."""
    import torch

    if not torch.cuda.is_available():
        return None
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


def library_key(source: bytes, flags: Sequence[str], capability: Optional[str]) -> str:
    """The entry key: sha256 of the source bytes, the flags and the
    capability."""
    h = hashlib.sha256(source)
    h.update(b"\0flags\0" + "\0".join(flags).encode())
    h.update(b"\0capability\0" + (capability or "none").encode())
    return h.hexdigest()


# libraries this process has loaded: (name, key) -> (CDLL, its file, the
# toolchain that built it).  One dlopen per library, whatever the store.
_LOADED: Dict[Tuple[str, str], Tuple[ctypes.CDLL, str, str]] = {}
_LOAD_LOCK = threading.RLock()


class AOTCache:
    """Content-addressed store of built kernel libraries in ``directory``.

    ``stats`` counts ``hits`` (loaded from the store, nothing built),
    ``misses`` (built, or copied from the library this process already
    loaded, and stored), ``errors`` (entries the loader refused, rebuilt),
    ``fallbacks`` (always 0: there is no other path to fall back to),
    ``evicted`` and ``orphans_removed`` (see :meth:`prune`).  A test
    asserting cold-start health checks ``stats["misses"] == 0`` after a
    warmed run.  ``build_seconds`` holds each build's wall seconds by
    library name; ``explain=True`` logs each hit and miss, and a miss's
    key parts.
    """

    def __init__(self, directory, max_bytes: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, mode=0o700, exist_ok=True)
        # mode= above only applies on CREATION (and is narrowed by the
        # umask): a pre-existing group/other-writable directory would
        # silently cross the trust boundary.  Tighten it if we own it;
        # refuse it otherwise.
        st = os.stat(self.directory)
        if st.st_mode & (_stat.S_IWGRP | _stat.S_IWOTH):
            if st.st_uid == os.getuid():
                os.chmod(self.directory, 0o700)
                logger.warning(
                    "AOT store %s was group/other-writable; tightened to "
                    "0700 (entries are shared libraries — writers can "
                    "execute code in every reader)",
                    self.directory,
                )
            else:
                raise ValueError(
                    f"AOT store {self.directory!r} is group/other-writable "
                    "and not owned by this user: entries are shared "
                    "libraries, so any writer can execute code in every "
                    "process that loads from the store.  Point aot_dir at a "
                    "directory owned by the serving user."
                )
        #: evict least-recently-used entries past this many bytes (``None``
        #: = unbounded).  Checked after every store write; see :meth:`prune`.
        self.max_bytes = max_bytes
        self.explain = False
        self.stats = {
            "hits": 0,
            "misses": 0,
            "errors": 0,
            "fallbacks": 0,
            "evicted": 0,
            "orphans_removed": 0,
        }
        self.build_seconds: Dict[str, float] = {}
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return f"AOTCache({self.directory!r})"

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    # -- layout --------------------------------------------------------

    def _fp_dir(self, toolchain: str) -> str:
        fp = hashlib.sha256(toolchain.encode()).hexdigest()[:16]
        return os.path.join(self.directory, f"fp-{fp}")

    def _fp_dirs(self) -> Dict[str, Optional[str]]:
        """``{fp-* directory: its recorded toolchain, or None}``."""
        found = {}
        with os.scandir(self.directory) as it:
            for e in it:
                if e.is_dir() and e.name.startswith("fp-"):
                    try:
                        with open(os.path.join(e.path, _TOOLCHAIN_FILE)) as f:
                            found[e.path] = f.read()
                    except OSError:
                        found[e.path] = None
        return found

    def _ensure_fp_dir(self, toolchain: str) -> str:
        d = self._fp_dir(toolchain)
        os.makedirs(d, mode=0o700, exist_ok=True)
        record = os.path.join(d, _TOOLCHAIN_FILE)
        if not os.path.exists(record):
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(toolchain)
            os.replace(tmp, record)
        return d

    @staticmethod
    def _entry(name: str, key: str) -> str:
        return f"{name}-{key}.so"

    def _lookup(self, lib: Library, key: str, toolchain: Optional[str]) -> Optional[str]:
        """The entry that serves ``lib`` here: the current toolchain's,
        or, with no compiler found, the newest of any toolchain of that
        compiler."""
        fname = self._entry(lib.name, key)
        if toolchain is not None:
            path = os.path.join(self._fp_dir(toolchain), fname)
            return path if os.path.exists(path) else None
        found = []
        for d, recorded in self._fp_dirs().items():
            if recorded is not None and recorded.split("\n", 1)[0] == lib.compiler:
                path = os.path.join(d, fname)
                try:
                    found.append((os.path.getmtime(path), path))
                except OSError:
                    pass
        return max(found)[1] if found else None

    # -- lifecycle -----------------------------------------------------

    @staticmethod
    def _is_entry(name: str) -> bool:
        return name.endswith(".so") and not name.startswith(".")

    def size_bytes(self) -> int:
        """Total bytes of stored libraries (all fingerprints)."""
        total = 0
        for d in self._fp_dirs():
            with os.scandir(d) as it:
                for e in it:
                    if self._is_entry(e.name):
                        try:
                            total += e.stat().st_size
                        except OSError:
                            pass
        return total

    def _orphaned(self, recorded: Optional[str]) -> bool:
        """Whether a directory of toolchain ``recorded`` can never serve on
        this machine: no record, or its compiler is found here at another
        release."""
        if recorded is None:
            return True
        compiler = recorded.split("\n", 1)[0]
        path = find_compiler(compiler)
        return path is not None and _toolchain(compiler, path) != recorded

    def prune(self, max_bytes: Optional[int] = None) -> dict:
        """Bound the store: sweep orphaned fingerprints, then evict
        least-recently-used live entries past ``max_bytes``.

        Orphans are every file under a ``fp-*`` directory that can never
        serve on this machine (see the toolkit rule in the module
        docstring): the directory goes with them.  Eviction order is by
        last use; newest survive.  ``max_bytes=None`` uses
        ``self.max_bytes``; if both are None only the orphan sweep runs.
        Returns ``{"orphans_removed", "evicted", "kept", "bytes"}`` and
        accumulates the first two into ``stats``.
        """
        if max_bytes is None:
            max_bytes = self.max_bytes
        orphans = evicted = 0
        entries = []
        for d, recorded in self._fp_dirs().items():
            if self._orphaned(recorded):
                with os.scandir(d) as it:
                    for e in it:
                        if e.name.endswith((".so", ".tmp")):
                            try:
                                os.unlink(e.path)
                                orphans += 1
                            except OSError:
                                pass
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(d, _TOOLCHAIN_FILE))
                with contextlib.suppress(OSError):
                    os.rmdir(d)
                continue
            with os.scandir(d) as it:
                for e in it:
                    if self._is_entry(e.name):
                        try:
                            st = e.stat()
                        except OSError:
                            continue
                        entries.append(
                            (max(st.st_atime, st.st_mtime), st.st_size, e.path)
                        )
        total = sum(size for _, size, _ in entries)
        if max_bytes is not None and total > max_bytes:
            for _, size, path in sorted(entries):  # oldest first
                if total <= max_bytes:
                    break
                try:
                    os.unlink(path)
                    total -= size
                    evicted += 1
                except OSError:
                    pass
        self._count("orphans_removed", orphans)
        self._count("evicted", evicted)
        return {
            "orphans_removed": orphans,
            "evicted": evicted,
            "kept": len(entries) - evicted,
            "bytes": total,
        }

    # -- core ----------------------------------------------------------

    def _hit(self, lib: Library, path: str) -> None:
        with contextlib.suppress(OSError):
            os.utime(path)  # LRU clock for prune(), noatime-proof
        self._count("hits")
        if self.explain:
            logger.warning("AOT hit: %s from %s", lib.name, path)

    def _explain_miss(self, lib: Library, key: str, toolchain: Optional[str], how: str):
        if self.explain:
            logger.warning(
                "AOT miss: %s (%s) in %s; key %s = sha256(source %s, flags %r, "
                "capability %s); toolchain %r",
                lib.name, how, self.directory, key[:16],
                lib.source, " ".join(lib.flags), lib.capability or "none",
                toolchain,
            )

    def _copy_in(self, lib: Library, key: str, src: str, toolchain: str) -> None:
        """Store a copy of the library file ``src`` this process loaded."""
        d = self._ensure_fp_dir(toolchain)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{lib.name}-", suffix=".tmp")
        os.close(fd)
        try:
            shutil.copyfile(src, tmp)
            os.replace(tmp, os.path.join(d, self._entry(lib.name, key)))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._count("misses")
        self._explain_miss(lib, key, toolchain, f"copied from {src}")

    def load_library(self, name: str, source, flags: Sequence[str], compiler: str,
                     capability: Optional[str] = None) -> ctypes.CDLL:
        """The loaded library ``name`` built from ``source`` with
        ``compiler`` and ``flags`` for ``capability``: from the store when
        it holds an entry (or this process loaded it already), else built
        and stored.  Raises where it must be built and ``compiler`` is not
        found."""
        lib = Library(name, Path(source), tuple(flags), compiler, capability)
        return self.load_libraries([lib])[name]

    def load_libraries(self, libs: Sequence[Library]) -> Dict[str, ctypes.CDLL]:
        """:meth:`load_library` of each of ``libs``, the builds started
        together (one compiler process each); ``{name: CDLL}``."""
        out = {}
        wrote = False
        with _LOAD_LOCK:
            jobs = []
            for lib in libs:
                key = library_key(Path(lib.source).read_bytes(), lib.flags, lib.capability)
                compiler = find_compiler(lib.compiler)
                toolchain = _toolchain(lib.compiler, compiler) if compiler else None
                path = self._lookup(lib, key, toolchain)
                loaded = _LOADED.get((lib.name, key))
                if loaded is not None:
                    out[lib.name], src, src_toolchain = loaded
                    if path is not None:
                        self._hit(lib, path)
                    else:
                        self._copy_in(lib, key, src, src_toolchain)
                        wrote = True
                    continue
                if path is not None:
                    try:
                        out[lib.name] = ctypes.CDLL(path)
                    except OSError as e:
                        self._count("errors")
                        logger.warning("AOT entry %s does not load (%s); rebuilding", path, e)
                    else:
                        recorded = self._fp_dirs().get(os.path.dirname(path))
                        _LOADED[(lib.name, key)] = (out[lib.name], path, recorded or toolchain)
                        self._hit(lib, path)
                        continue
                if compiler is None:
                    raise RuntimeError(
                        f"AOT store {self.directory!r} holds no loadable {lib.name} "
                        f"library for this source, these flags and capability "
                        f"{lib.capability or 'none'}, and {lib.compiler} is not found "
                        f"(on PATH{' or under $CUDA_HOME/bin' if lib.compiler == 'nvcc' else ''}) "
                        f"to build one: warm the store where {lib.compiler} is "
                        "installed (--precompile --aot-dir, or "
                        "speech_tpu_torch.aot.precompile_extractor)"
                    )
                d = self._ensure_fp_dir(toolchain)
                fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{lib.name}-", suffix=".tmp.so")
                os.close(fd)
                log = tempfile.TemporaryFile(mode="w+")  # no pipe to fill
                proc = subprocess.Popen(
                    [compiler, *lib.flags, "-o", tmp, str(lib.source)],
                    stdout=log, stderr=subprocess.STDOUT, text=True,
                )
                jobs.append((lib, key, toolchain, d, tmp, proc, log))
            # each build's own seconds: poll them all, as they run together
            t0, seconds = time.perf_counter(), {}
            while len(seconds) < len(jobs):
                for _, _, _, _, _, proc, _ in jobs:
                    if proc not in seconds and proc.poll() is not None:
                        seconds[proc] = time.perf_counter() - t0
                if time.perf_counter() - t0 > _BUILD_TIMEOUT_S:
                    for _, _, _, _, _, proc, _ in jobs:
                        if proc not in seconds:
                            proc.kill()
                            proc.wait()
                            seconds[proc] = time.perf_counter() - t0
                time.sleep(0.02)
            errors = []
            for lib, key, toolchain, d, tmp, proc, log in jobs:
                try:
                    if proc.returncode != 0:
                        log.seek(0)
                        errors.append(f"{lib.compiler} failed on {lib.source}:\n{log.read()}")
                        continue
                    target = os.path.join(d, self._entry(lib.name, key))
                    os.replace(tmp, target)  # atomic under concurrent writers
                finally:
                    log.close()
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                self.build_seconds[lib.name] = seconds[proc]
                out[lib.name] = ctypes.CDLL(target)
                _LOADED[(lib.name, key)] = (out[lib.name], target, toolchain)
                self._count("misses")
                self._explain_miss(lib, key, toolchain, f"built in {seconds[proc]:.1f} s")
                wrote = True
            if errors:
                raise RuntimeError("\n".join(errors))
            if wrote and self.max_bytes is not None:
                self.prune()
        return out


# -- the store kernel wrappers read ------------------------------------

_DEFAULT: Optional[AOTCache] = None
_DEFAULT_LOCK = threading.Lock()
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("speech_tpu_torch_aot", default=None)


def default_store() -> AOTCache:
    """The process default store: :data:`DEFAULT_DIR`, unless
    :func:`set_default_store` moved it."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = AOTCache(DEFAULT_DIR)
        return _DEFAULT


def set_default_store(store) -> AOTCache:
    """Make ``store`` (a path or an :class:`AOTCache`) the process
    default; returns it."""
    global _DEFAULT
    store = as_cache(store)
    with _DEFAULT_LOCK:
        _DEFAULT = store
    return store


def active_store() -> AOTCache:
    """The store of the innermost :func:`using` block of this thread (or
    task), else the process default."""
    store = _ACTIVE.get()
    return store if store is not None else default_store()


@contextlib.contextmanager
def using(store: Optional[AOTCache]):
    """Take kernel libraries from ``store`` inside the block (None: leave
    the active store as it is)."""
    if store is None:
        yield
        return
    token = _ACTIVE.set(store)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def precompile_extractor(
    extractor,
    lengths: Sequence[int],
    batches: Sequence[int],
    dtypes=(np.float32,),
    progress=None,
) -> int:
    """Load (and store) every library an extraction run will need.

    The JAX package's grid: for each length bucket covering ``lengths``,
    each (deduplicated, mesh-rounded) batch size in ``batches``, and each
    input ``dtype``, one zero batch runs through ``extractor`` with host
    lengths (the static all-full route) and with a lengths tensor (the
    ragged route), so the libraries of every route the run takes land in
    its store.  Returns the number of grid points exercised, two a
    bucket (store hits included).  ``progress`` (optional callable taking
    a message) reports each point; then the libraries of the extractor's
    own batches (:meth:`~speech_tpu_torch.parallel.ShardedExtractor.load_libraries`).
    """
    import torch

    buckets = sorted({extractor.bucket_len(max(int(n), 1)) for n in lengths})
    rounded = sorted(
        {
            -(-int(b) // extractor.batch_multiple) * extractor.batch_multiple
            for b in batches
        }
    )
    count = 0
    for dtype in dtypes:
        for b in rounded:
            for n in buckets:
                count += 2  # static all-full + ragged-lengths routes
                if progress is not None:
                    progress(
                        f"precompile bucket={n} batch={b} "
                        f"dtype={np.dtype(dtype).name}"
                    )
                signals = np.zeros((b, n), dtype=dtype)
                lengths_np = np.full((b,), n, dtype=np.int64)
                extractor.extract_batch(signals, lengths_np)
                extractor.extract_batch(signals, torch.from_numpy(lengths_np))
    extractor.load_libraries()
    return count
