"""Serving runtime: micro-batched extraction and concurrent streams.

The counterpart of :mod:`speech_tpu.serve`.  One card runs the fused
pipeline many thousands of times faster than real time, so the serving
problem is keeping it fed from many concurrent, individually tiny
requests:

- :class:`FeatureServer` -- request batching.  Callers submit whole
  signals from any thread and get a :class:`concurrent.futures.Future`; a
  background dispatcher coalesces requests into latency-bounded
  micro-batches and runs them through
  :class:`~speech_tpu_torch.parallel.ShardedExtractor`, so each micro-batch
  takes the computer's own route (at 'double' on the card: one launch of
  the int8 digit kernel).
- :class:`StreamPool` -- a fixed pool of concurrent streaming sessions:
  every streamer state carries a leading stream axis of the pool's slots,
  and a tick is one ``_process_impl`` over that axis with per-slot valid
  counts (idle slots pass 0 and are exact no-ops), where the JAX package
  ``vmap`` s.
- :class:`StreamServer` -- the thread-safe loop around a
  :class:`StreamPool`: callers open/feed/close sessions from any thread;
  a background loop coalesces feeds, ticks the pool, and delivers feature
  blocks to per-session queues.

Both servers serve on a mesh of several processes (one card each): every
rank constructs the server with the same arguments, rank 0 (the front)
alone takes requests and decides each micro-batch or tick, and the other
ranks (followers) run their row or slot block of each step in a background
thread (:mod:`speech_tpu_torch.parallel._relay`).  A follower's client
methods raise; its ``close`` returns once the front's close reaches it.

Device work runs on the computer's (or streamer's) own device, named
explicitly: a server thread never relies on the thread's current device.
"""

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from .aot import as_cache
from .parallel import ShardedExtractor
from .parallel import _relay
from .parallel.mesh import axis_size, global_tensor
from .streaming import StreamingSI, StreamingSTFT, _tree_map

__all__ = ["FeatureServer", "StreamPool", "StreamServer"]


def _device_scope(device: torch.device):
    """Make ``device`` the thread's current card inside the block (a new
    thread's current card is card 0, whatever the caller's is)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _named(device: torch.device) -> torch.device:
    """``device`` with its card named: a bare ``"cuda"`` is the
    constructing thread's current card (one process a card on a mesh),
    which a server thread must not read as its own card 0."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _relay_of(mesh, rows: int = 0):
    """The relay of a server on ``mesh`` (on a mesh of one process, the
    front's alone); None without a mesh."""
    return None if mesh is None else _relay.Relay(mesh, rows=rows)


def _follower_error(name: str) -> RuntimeError:
    return RuntimeError(
        f"{name} on a follower: on a mesh of several processes only rank 0 "
        "takes requests"
    )


# the dispatcher holds nothing (None is the stop it may hold)
_NOTHING = object()


class _Warmup:
    """A warm-up the dispatcher runs between micro-batches."""

    __slots__ = ("lengths", "tiers", "dtype", "fut")

    def __init__(self, lengths, tiers, dtype):
        self.lengths, self.tiers, self.dtype = lengths, tiers, dtype
        self.fut = Future()


class FeatureServer:
    """Thread-safe micro-batching front end for whole-signal extraction.

    Parameters
    ----------
    computer
        A frame computer (STFT or SI) of this package.
    mesh
        Optional device mesh: each micro-batch shards over its data axis,
        every process running its row block on its own card.  On a mesh of
        several processes every rank constructs the server with the same
        arguments; rank 0 alone takes requests and decides each
        micro-batch, which it relays to the other ranks (their client
        methods raise ``RuntimeError``).  The mesh must span the process
        group, and while the server runs its dispatcher runs collectives
        on the default group: the caller runs none of its own there
        until ``close``.
    max_batch
        Largest micro-batch dispatched to the device at once.
    max_wait_ms
        How long the dispatcher waits to fill a batch after the first
        pending request before running a partial one.  The latency floor
        for a lone request is roughly this plus one device dispatch.
    pad_batches
        ``True`` (default): pad every micro-batch to ``max_batch`` rows,
        so that each length bucket has one batch shape whatever the load.
        ``"pow2"``: pad to the next power of two instead, so device time
        follows the load level.  ``False``: no padding.
    max_pending
        Admission control: with this many requests enqueued, ``submit``
        raises RuntimeError instead of growing the queue without bound.
        None (default) disables the limit.
    bucket
        Signal-length bucket granularity, forwarded to
        :class:`~speech_tpu_torch.parallel.ShardedExtractor`: ``"pow2"``
        (default) or ``"fine"``.
    postprocessors
        Optional host post-processor instances run on the device after the
        features (forwarded to the extractor).
    aot_dir
        Optional store of kernel libraries
        (:class:`speech_tpu_torch.aot.AOTCache` or its path), forwarded to
        the extractor: libraries a previous process built load from it,
        so the first request pays no build.  Its stats are
        ``server._extractor.aot.stats``.

    Attributes
    ----------
    stats
        Monotonic counters: ``submitted``, ``completed``, ``failed``,
        ``rejected`` (admission control), ``batches`` (device dispatches),
        ``queue_wait_s`` (summed seconds from each request's ``submit`` to
        the start of the first micro-batch launch that carries it).  On a
        mesh of several processes, the front's.
    """

    def __init__(
        self,
        computer,
        mesh=None,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        pad_batches=True,
        max_pending: int = None,
        bucket: str = "pow2",
        postprocessors=(),
        aot_dir: str = None,
    ):
        if pad_batches not in (True, False, "pow2"):
            raise ValueError(
                f"pad_batches must be True, False, or 'pow2'; got {pad_batches!r}"
            )
        self._extractor = ShardedExtractor(
            computer, mesh, bucket=bucket, postprocessors=postprocessors,
            aot_dir=aot_dir,
        )
        self._device = _named(computer.device)
        self._max_batch = int(max_batch)
        m = self._extractor.batch_multiple
        self._relay = _relay_of(mesh, rows=-(-self._max_batch // m) * m)
        self._seq = 0  # the front's last relayed micro-batch
        self._pad_batches = pad_batches
        self._max_wait = float(max_wait_ms) / 1e3
        self._max_pending = None if max_pending is None else int(max_pending)
        self._pending = 0  # requests submitted but not yet resolved
        self._queue = queue.SimpleQueue()
        self._closed = False
        # makes submit's check + put atomic with close's sentinel, so no
        # request can slip behind the stop
        self._lock = threading.Lock()
        self.stats = {"submitted": 0, "completed": 0, "failed": 0, "rejected": 0, "batches": 0,
                      "queue_wait_s": 0.0}
        follower = self._relay is not None and not self._relay.front
        self._worker = threading.Thread(
            target=self._follow if follower else self._run, name="speech-tpu-serve", daemon=True
        )
        self._worker.start()

    # -- client side -------------------------------------------------------

    def _check_front(self, name: str) -> None:
        if self._relay is not None and not self._relay.front:
            raise _follower_error(name)

    def submit(self, signal: np.ndarray) -> Future:
        """Enqueue one 1-D signal; resolves to ``(num_frames, C)``.

        Malformed requests raise *here*, to the submitting caller -- a bad
        signal must never poison the unrelated requests it would have
        coalesced with in a micro-batch.
        """
        self._check_front("submit")
        signal = np.asarray(signal)
        if signal.ndim != 1:
            raise ValueError(f"signal must be 1-D, got shape {signal.shape}")
        if not np.issubdtype(signal.dtype, np.number):
            raise TypeError(f"signal must be numeric, got {signal.dtype}")
        fut = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if self._max_pending is not None and self._pending >= self._max_pending:
                self.stats["rejected"] += 1
                raise RuntimeError(
                    f"server overloaded: {self._pending} requests pending "
                    f"(max_pending={self._max_pending})"
                )
            self._pending += 1
            self.stats["submitted"] += 1
            self._queue.put((signal, fut, time.perf_counter()))
        return fut

    def extract(self, signal: np.ndarray) -> np.ndarray:
        """Blocking single-signal convenience wrapper."""
        return self.submit(signal).result()

    def extract_many(self, signals: Sequence[np.ndarray]):
        """Submit a burst and wait for all results (in order)."""
        futs = [self.submit(s) for s in signals]
        return [f.result() for f in futs]

    def warmup(self, lengths: Sequence[int], batch: int = None, dtype=np.float32) -> None:
        """Run a zero batch through each distinct length bucket covering
        ``lengths`` (and, under ``"pow2"``, each power-of-two batch tier),
        so that one-time costs (kernel builds, packed weights, cuBLAS and
        cuDNN handles, and the pinned host buffers of the two batches the
        dispatcher's double buffer holds at once) land here rather than
        on the first requests.  Blocking; the dispatcher runs it between
        micro-batches (on a mesh of several processes every rank runs it),
        and its batches count in no stat."""
        self._check_front("warmup")
        if batch is not None:
            tiers = [int(batch)]
        elif self._pad_batches == "pow2":
            tiers = []
            t = 1
            while t < self._max_batch:
                tiers.append(t)
                t <<= 1
            tiers.append(self._max_batch)
        elif self._pad_batches:
            tiers = [1]
        else:
            tiers = [self._max_batch]
        job = _Warmup(list(lengths), tiers, dtype)
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(job)
        job.fut.result()

    def _warm(self, job: _Warmup) -> None:
        done = set()
        for n in job.lengths:
            n = max(int(n), 1)
            key = self._extractor.bucket_len(n)
            if key in done:
                continue
            done.add(key)
            for t in job.tiers:
                zeros = [np.zeros(n, job.dtype)] * t
                # two in flight before the first readback, as under load
                inflight = [self._launch(zeros, self._min_batch(t)) for _ in range(2)]
                for disp in inflight:
                    self._readback(disp)

    def _min_batch(self, n: int) -> int:
        """Batch-dim padding target for an ``n``-request micro-batch."""
        if self._pad_batches == "pow2":
            return min(self._max_batch, 1 << max(0, n - 1).bit_length())
        return self._max_batch if self._pad_batches else 0

    def close(self) -> None:
        """Drain pending requests and stop the dispatcher.

        Requests submitted before the close are served; the lock makes a
        racing submit either land before the stop sentinel or raise.  Any
        item somehow found behind the sentinel after the dispatcher exits
        gets a RuntimeError rather than a future that never resolves.  On
        a follower, waits until the front's close reaches it.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, _Warmup):
                item.fut.set_exception(RuntimeError("server is closed"))
            elif item is not None:
                self._done(item[1], exc=RuntimeError("server is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher --------------------------------------------------------

    def _run(self) -> None:
        with _device_scope(self._device):
            try:
                self._serve()
            finally:
                if self._relay is not None:
                    self._relay.send(_relay.STOP)

    def _serve(self) -> None:
        """Dispatcher loop, double-buffered under sustained load.

        Dispatch (``_launch``) queues the device work without waiting for
        it, while the readback (``_readback``) waits.
        Holding one in-flight batch lets the host padding of batch ``i+1``
        overlap the device work of batch ``i``; with an empty queue the
        in-flight batch is read back at once, so a lone request never
        waits on a successor that may not come.  A warm-up or the stop met
        while filling a batch is held until that batch is dispatched.
        """
        pending = None  # (batch, dispatch result) awaiting its readback
        held = _NOTHING  # the warm-up or stop (None) met while filling
        while True:
            item, held = (self._queue.get() if held is _NOTHING else held), _NOTHING
            if item is None or isinstance(item, _Warmup):
                if pending is not None:
                    self._resolve(pending)
                    pending = None
                if item is None:
                    return
                try:
                    self._warm(item)
                except Exception as e:  # noqa: BLE001 -- to the caller
                    item.fut.set_exception(e)
                else:
                    item.fut.set_result(None)
                continue
            batch = [item]
            deadline = time.monotonic() + self._max_wait
            while len(batch) < self._max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None or isinstance(nxt, _Warmup):
                    held = nxt
                    break
                batch.append(nxt)
            disp = self._dispatch(batch)
            prev, pending = pending, (None if disp is None else (batch, disp))
            if prev is not None:
                self._resolve(prev)
            if disp is None:
                self._retry_individually(batch)
            elif held is not _NOTHING or self._queue.empty():
                self._resolve(pending)
                pending = None

    def _launch(self, signals, min_batch: int):
        """Queue one micro-batch on every rank; raises if any rank's part
        failed.  On a mesh of several processes the front sends its header
        and rows, and the result carries its sequence number."""
        if self._relay is None:
            return self._extractor._dispatch(signals, min_batch=min_batch)
        ex = self._extractor
        lengths, max_len, buf_dtype = ex._host_batch(signals, min_batch)
        buf, table = ex._host_rows(signals, lengths, max_len, buf_dtype, 0, lengths.size)
        rows, _ = ex._lay_out(buf, table, max_len)
        self._seq += 1
        self._relay.send(_relay.BATCH, self._seq, max_len, int(buf_dtype == torch.int16),
                         len(signals), lengths)
        return (*self._relayed(lengths, max_len, buf_dtype, len(signals), rows), self._seq)

    def _relayed(self, lengths, max_len: int, buf_dtype, n: int, rows=None):
        """This rank's part of a relayed micro-batch: its row block from
        the front (``rows``: the front's whole padded batch, on its card
        or on the host),
        its features queued, and every rank's agreement that its part ran;
        raises if any rank's part failed."""
        ex, relay = self._extractor, self._relay
        start, per = ex._row_block(lengths.size)
        dev = self._device
        blocks = None
        if rows is not None:
            rows = rows.to(dev, non_blocking=True)
            blocks = [rows[b * per: (b + 1) * per] for b in range(ex.batch_multiple)]
        block = relay.scatter(torch.empty((per, max_len), dtype=buf_dtype, device=dev), blocks)
        err = None
        try:
            feats, counts = ex._run_block(block, lengths, max_len, start)
        except Exception as e:  # noqa: BLE001 -- agreed on below
            err = e
        if not relay.agree(err is None):
            raise err or RuntimeError("the micro-batch failed on another rank")
        return feats, counts, n

    def _readback(self, disp):
        """A micro-batch's rows, read back to the host (on a mesh of
        several processes, gathered to the front)."""
        if self._relay is None:
            return self._extractor._collect(*disp)
        feats, counts, n, seq = disp
        self._relay.send(_relay.COLLECT, seq)
        return self._gather(feats, counts, n)

    def _gather(self, feats, counts, n):
        feats, counts = self._relay.gather(feats), self._relay.gather(counts)
        if feats is None:
            return None
        return self._extractor._collect(feats, counts, n)

    def _follow(self) -> None:
        """A follower's loop: run each micro-batch the front relays, keep
        it until the front collects it, until the front stops."""
        inflight = {}
        with _device_scope(self._device):
            while True:
                op, seq, max_len, buf_type, n, lengths = self._relay.recv()
                if op == _relay.STOP:
                    return
                if op == _relay.COLLECT:
                    self._gather(*inflight.pop(seq))
                    continue
                buf_dtype = torch.int16 if buf_type else self._extractor._computer._dtype
                try:
                    inflight[seq] = self._relayed(lengths, max_len, buf_dtype, n)
                except Exception:  # noqa: BLE001 -- the front retries or fails it
                    pass

    def _dispatch(self, batch):
        """Queue one micro-batch; None on failure (the caller then retries
        its requests one by one)."""
        t = time.perf_counter()
        waited = sum(t - t_submit for _, _, t_submit in batch)
        with self._lock:
            self.stats["queue_wait_s"] += waited
        try:
            disp = self._launch([s for s, _, _ in batch], self._min_batch(len(batch)))
        except Exception:  # noqa: BLE001 -- isolate the bad request(s)
            return None
        with self._lock:
            self.stats["batches"] += 1
        return disp

    def _resolve(self, entry) -> None:
        batch, disp = entry
        try:
            outs = self._readback(disp)
        except Exception:  # noqa: BLE001 -- isolate the bad request(s)
            self._retry_individually(batch)
            return
        for (_, fut, _), out in zip(batch, outs):
            self._done(fut, out)

    def _retry_individually(self, batch) -> None:
        # submit() pre-validates shape/dtype, so batch failures here are
        # rare; retry each request alone on the same extractor, so that
        # only the offending request sees the error (never computed
        # elsewhere)
        for sig, fut, _ in batch:
            try:
                out = self._readback(self._launch([sig], 0))[0]
            except Exception as e:  # noqa: BLE001 -- to the caller
                self._done(fut, exc=e)
            else:
                self._done(fut, out)

    def _done(self, fut, result=None, exc=None) -> None:
        with self._lock:
            self._pending -= 1
            self.stats["failed" if exc is not None else "completed"] += 1
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)


class _Session:
    __slots__ = ("slot", "pending", "open")

    def __init__(self, slot: int, dtype):
        self.slot = slot
        self.pending = np.zeros((0,), dtype)
        self.open = True


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class StreamPool:
    """Fixed pool of concurrent streaming sessions on one device or a mesh.

    Works with either computer (the STFT and SI streamers share the
    explicit-carry contract), or with any pre-built streamer honouring it
    (``init_state(streams=)`` / ``_process_impl`` / ``_finalize_impl``,
    with valid-0 no-op steps: ``StreamingPitch``, ``StreamingKWS``,
    ``StreamingSpeaker``).  The slots' states carry a leading stream axis,
    and a :meth:`step` is one ``_process_impl`` over it; partial chunks are
    consumed at once as masked chunks.  On a single device the tick is
    **occupancy-tiered**: only the slots with pending samples are gathered
    (``index_select``) into a power-of-two sub-batch, stepped, and
    scattered back (``index_copy``), so a tick's cost follows the number of
    active sessions, not the pool's capacity.  With a ``mesh``, each
    process ticks its own contiguous block of the slots (sessions are
    independent: the tick needs no collectives) and the emitted rows are
    gathered, so every process must drive the pool the same way.  A tick
    queues no host synchronisation; its results come back in one readback
    (into pinned memory from a card).  Not thread-safe: drive it from one
    serving loop (:class:`StreamServer` does).

    ``aot_dir`` (path or :class:`speech_tpu_torch.aot.AOTCache`) is kept
    as ``pool.aot``, as the JAX package keeps its store, so a serving
    process can share one store between its objects.  The ticks launch no
    hand-written kernel, so they add nothing to it.

    Typical loop::

        pool = StreamPool(computer, slots=8, chunk_size=1600)
        h = pool.open()
        pool.feed(h, samples)          # any-length append
        for h2, feats in pool.step():  # one device tick
            deliver(h2, feats)
        for h2, feats in pool.close(h):
            deliver(h2, feats)
    """

    def __init__(
        self,
        computer,
        slots: int = 8,
        chunk_size: int = 1600,
        mesh=None,
        data_axis: str = "data",
        aot_dir=None,
    ):
        from .compute import ShortIntegrationFrameComputer

        self.aot = as_cache(aot_dir)  # path, AOTCache, or None
        if hasattr(computer, "init_state") and hasattr(computer, "_process_impl"):
            # a pre-built streamer; its own chunk size governs
            self._stream = computer
            chunk_size = computer.chunk_size
        else:
            cls = (
                StreamingSI
                if isinstance(computer, ShortIntegrationFrameComputer)
                else StreamingSTFT
            )
            self._stream = cls(computer, chunk_size)
        self._slots = int(slots)
        self._chunk = int(chunk_size)
        self._device = self._stream.device
        self._dtype = _NP_DTYPES[self._stream._dtype]
        self._mesh = mesh
        self._data_axis = data_axis
        if mesh is not None:
            n = axis_size(mesh, data_axis)
            if self._slots % n:
                raise ValueError(
                    f"slots ({self._slots}) must be a multiple of the mesh's "
                    f"'{data_axis}' axis ({n})"
                )
            self._local = self._slots // n
            self._first = mesh.get_local_rank(data_axis) * self._local
        else:
            self._local, self._first = self._slots, 0
        self._states = self._stream.init_state(streams=self._local)
        self._init_single = _tree_map(lambda x: x[0].clone(), self._states)
        self._sessions = {}
        self._free = list(range(self._slots))
        self._next_handle = 0
        self._tiered = mesh is None

    @property
    def capacity(self) -> int:
        return len(self._free)

    def warmup(self, depths: Sequence[int] = (1,), occupancies: Sequence[int] = ()) -> None:
        """Run the tick at the given chunk depths (each padded to its
        power-of-two tier), the occupancy-tiered ticks at the given
        active-slot counts (ignored on a mesh) and the finalize, before any
        session opens, so that one-time costs land here.  Every warm-up
        step carries ``valid_len`` 0 -- an exact no-op on the states (the
        states are not even kept)."""
        for d in depths:
            k = _pow2(d)
            chunks = torch.zeros((self._local, k * self._chunk), dtype=self._stream._dtype,
                                 device=self._device)
            valids = torch.zeros(self._local, dtype=torch.int64, device=self._device)
            self._stream._process_impl(self._states, chunks, valids)
            if self._tiered:
                for occ in occupancies:
                    tier = _pow2(occ)
                    if tier >= self._slots:
                        continue
                    idx = torch.zeros(tier, dtype=torch.int64, device=self._device)
                    self._tiered_step(idx, chunks[:tier], valids[:tier])
        self._stream._finalize_impl(self._states)

    # -- session management ------------------------------------------------

    def open(self) -> int:
        """Claim a slot; returns a session handle."""
        if not self._free:
            raise RuntimeError("no free stream slots")
        slot = self._free.pop()
        self._set_slot(slot, self._init_single)
        handle = self._next_handle
        self._next_handle += 1
        self._sessions[handle] = _Session(slot, self._dtype)
        return handle

    def feed(self, handle: int, samples: np.ndarray) -> None:
        """Append samples to a session (no device work until step())."""
        s = self._session(handle)
        samples = np.asarray(samples, self._dtype).ravel()
        s.pending = np.concatenate([s.pending, samples])

    def step(self, only=None, max_chunks: int = 1):
        """One device tick: consume up to ``max_chunks`` chunks per session.

        Returns ``[(handle, feats)]`` for sessions that emitted frames.
        With ``max_chunks > 1`` each session's backlog runs as ONE wide
        masked chunk -- all its frames in one batch of products, and one
        dispatch for the whole backlog.  The width pads to a power of two
        of chunks.  ``only`` restricts consumption to one session or a set
        of sessions (other sessions' states are untouched exact no-ops) --
        used by :meth:`close` / :meth:`close_many` so that draining never
        swallows other sessions' output.
        """
        return self._finish_tick(self._queue_tick(only, max_chunks))

    def _plan(self, only, max_chunks: int):
        C = self._chunk
        if only is not None and not isinstance(only, (set, frozenset)):
            only = {only}
        plan = {}
        kmax = 0
        for handle, s in self._sessions.items():
            if only is not None and handle not in only:
                continue
            n = len(s.pending)
            if n == 0:
                continue
            nchunks = min(int(max_chunks), -(-n // C))
            plan[handle] = min(n, nchunks * C)
            kmax = max(kmax, nchunks)
        return plan, _pow2(kmax) if plan else 0

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the pool's device without a host sync: through
        pinned memory with a non-blocking copy on a card."""
        t = torch.from_numpy(arr)
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _queue_tick(self, only=None, max_chunks: int = 1):
        """Plan a tick and queue its device work (no host sync); returns
        the pending record :meth:`_finish_tick` reads back."""
        plan, k = self._plan(only, max_chunks)
        if not plan:
            return None
        C = self._chunk
        m = len(plan)
        tier = _pow2(m)  # pow2 slot tiers
        if self._tiered and tier < self._slots:
            # occupancy-tiered tick: gather only the active slots (plus pad
            # duplicates of ONE idle slot -- its valid-0 step gives back
            # bitwise the state already there, so duplicate scatter rows
            # cannot disagree), step the sub-batch, scatter the states back
            active = [self._sessions[h].slot for h in plan]
            active_set = set(active)
            pad = next(i for i in range(self._slots) if i not in active_set)
            idx = np.asarray(active + [pad] * (tier - m), np.int64)
            chunks = np.zeros((tier, k * C), self._dtype)
            valids = np.zeros((tier,), np.int64)
            for pos, (handle, take) in enumerate(plan.items()):
                chunks[pos, :take] = self._sessions[handle].pending[:take]
                valids[pos] = take
            feats, nfs = self._tiered_step(
                self._to_device(idx), self._to_device(chunks), self._to_device(valids)
            )
            rows = {h: pos for pos, h in enumerate(plan)}
        else:
            chunks = np.zeros((self._slots, k * C), self._dtype)
            valids = np.zeros((self._slots,), np.int64)
            for handle, take in plan.items():
                s = self._sessions[handle]
                chunks[s.slot, :take] = s.pending[:take]
                valids[s.slot] = take
            lo, hi = self._first, self._first + self._local
            self._states, feats, nfs = self._stream._process_impl(
                self._states, self._to_device(chunks[lo:hi]), self._to_device(valids[lo:hi])
            )
            feats, nfs = self._gathered(feats, nfs)
            rows = {h: self._sessions[h].slot for h in plan}
        return plan, rows, feats, nfs

    def _tiered_step(self, idx, chunks, valids):
        sub = _tree_map(lambda a: a.index_select(0, idx), self._states)
        sub, feats, nfs = self._stream._process_impl(sub, chunks, valids)
        # out of place: a leaf the streamer returned may be a view of a
        # wider buffer, which an in-place scatter would write through
        self._states = _tree_map(lambda full, s: full.index_copy(0, idx, s), self._states, sub)
        return feats, nfs

    def _gathered(self, *local):
        """On a mesh, every process's block of the slots, whole."""
        if self._mesh is None:
            return local
        return tuple(global_tensor(t.contiguous(), self._mesh, self._data_axis).full_tensor()
                     for t in local)

    @staticmethod
    def _readback(*tensors):
        """The tick's one readback: from a card, into pinned host memory
        with one wait."""
        if tensors[0].device.type != "cuda":
            return tuple(t.numpy() for t in tensors)
        pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for dst, src in zip(pinned, tensors):
            dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        return tuple(t.numpy() for t in pinned)

    def _finish_tick(self, pending):
        if pending is None:
            return []
        plan, rows, feats, nfs = pending
        feats, nfs = self._readback(feats, nfs)
        out = []
        for handle, take in plan.items():
            s = self._sessions[handle]
            s.pending = s.pending[take:]
            row = rows[handle]
            nf = int(nfs[row])
            if nf:
                out.append((handle, feats[row, :nf].copy()))
        return out

    def close(self, handle: int):
        """Drain, finalize, and release a session.

        Returns ``[(handle, feats)]`` segments in stream order (possibly
        several from draining, then the finalize flush).
        """
        return self.close_many([handle])

    def close_many(self, handles):
        """Drain, finalize, and release several sessions at once.

        One finalize over the slots' axis and one readback cover every
        closing session.  Returns ``[(handle, feats)]`` segments, drained
        chunks first, then each session's finalize flush in ``handles``
        order.
        """
        handles = list(dict.fromkeys(handles))  # dedupe, order-preserving
        sessions = {h: self._session(h) for h in handles}
        out = []
        while any(len(s.pending) for s in sessions.values()):
            backlog = max(
                -(-len(s.pending) // self._chunk) for s in sessions.values() if len(s.pending)
            )
            out.extend(self.step(only=set(handles), max_chunks=backlog))
        fin_feats, fin_ns = self._readback(
            *self._gathered(*self._stream._finalize_impl(self._states))
        )
        for handle in handles:
            s = sessions[handle]
            nf = int(fin_ns[s.slot])
            if nf:
                out.append((handle, fin_feats[s.slot, :nf].copy()))
            s.open = False
            del self._sessions[handle]
            self._free.append(s.slot)
        return out

    # -- internals ---------------------------------------------------------

    def _session(self, handle: int) -> _Session:
        try:
            return self._sessions[handle]
        except KeyError:
            raise KeyError(f"no open session {handle}") from None

    def _set_slot(self, slot: int, state) -> None:
        local = slot - self._first
        if not 0 <= local < self._local:
            return  # another process's slot
        idx = torch.tensor([local], device=self._device)
        self._states = _tree_map(
            lambda batched, single: batched.index_copy(0, idx, single[None]),
            self._states, state,
        )


def _settle(fut, result=None, exc=None) -> None:
    """Resolve a loop command's future (a follower's commands have none)."""
    if fut is None:
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)


class StreamServer:
    """Thread-safe streaming front end around a :class:`StreamPool`.

    The pool itself is single-loop by design; this class owns that loop:
    callers open, feed, and close sessions from any thread, a background
    thread coalesces feeds for up to ``max_wait_ms``, ticks the pool
    (backlogs drain as wide chunks, bounded by ``tick_chunks``), and
    delivers feature blocks to per-session queues.

    Typical use::

        with StreamServer(computer, slots=16, chunk_size=1600) as server:
            h = server.open_session()
            server.feed(h, samples)          # from any thread
            server.close_session(h)          # flush; marks the stream done
            for feats in server.iter_results(h):
                deliver(feats)

    ``iter_results`` may also run concurrently with feeding (it blocks
    until blocks arrive and stops after ``close_session``'s flush).

    On a mesh of several processes every rank constructs the server with
    the same arguments.  Rank 0 alone takes sessions: each loop iteration
    it sends its ordered commands (warm-up, open, feed with the samples,
    close) and the tick's ``max_chunks`` to the other ranks, whose loop
    applies them to its own pool in the same order (handles agree: a
    pool opens them in order) and ticks its block of the slots.  A tick
    that fails on any rank fails its sessions on every rank.  The other
    ranks' client methods raise ``RuntimeError``; their ``close`` returns
    once the front's close reaches them.

    Parameters
    ----------
    computer, slots, chunk_size, mesh
        Forwarded to :class:`StreamPool`.
    tick_chunks
        Largest per-session backlog consumed per device tick (wide masked
        chunks; pads to power-of-two tiers).
    max_wait_ms
        How long the loop waits for more feeds before ticking with what it
        has -- the added latency ceiling under light load.
    aot_dir
        Forwarded to :class:`StreamPool` (``server._pool.aot``).
    """

    def __init__(
        self,
        computer,
        slots: int = 8,
        chunk_size: int = 1600,
        mesh=None,
        tick_chunks: int = 16,
        max_wait_ms: float = 2.0,
        aot_dir=None,
    ):
        self._pool = StreamPool(
            computer, slots=slots, chunk_size=chunk_size, mesh=mesh, aot_dir=aot_dir
        )
        self._device = _named(self._pool._device)
        self._relay = _relay_of(mesh)
        self._tick_chunks = int(tick_chunks)
        self._wait = float(max_wait_ms) / 1e3
        self._cmds = queue.SimpleQueue()
        self._results = {}
        self._closed = False
        self._lock = threading.Lock()
        follower = self._relay is not None and not self._relay.front
        self._worker = threading.Thread(
            target=self._follow if follower else self._run, name="speech-tpu-stream-serve",
            daemon=True,
        )
        self._worker.start()

    # -- client side (any thread) ----------------------------------------

    def warmup(self, depths=None, occupancies=()) -> None:
        """Run the tick at its depths before traffic arrives (blocking;
        inside the loop thread -- the pool is not thread-safe), and on a
        mesh one gather of the slots.  ``depths`` defaults to the
        power-of-two tiers up to ``tick_chunks``; ``occupancies`` forwards
        to :meth:`StreamPool.warmup`."""
        if depths is None:
            depths = []
            d = 1
            while d < self._tick_chunks:
                depths.append(d)
                d <<= 1
            depths.append(self._tick_chunks)
        fut = Future()
        self._submit(("warmup", tuple(depths), tuple(occupancies), fut), "warmup")
        fut.result()

    def open_session(self) -> int:
        """Claim a pool slot; returns a session handle (blocking).

        Raises RuntimeError when no slot is free -- admission control is
        the pool size.
        """
        fut = Future()
        self._submit(("open", fut), "open_session")
        return fut.result()

    def feed(self, handle: int, samples) -> None:
        """Append samples to a session (returns immediately).

        Malformed input raises *here*, to the caller -- it must never
        reach the loop thread (a dead loop would hang every session).
        """
        samples = np.asarray(samples)
        if samples.ndim != 1:
            raise ValueError(f"samples must be 1-D, got shape {samples.shape}")
        if not np.issubdtype(samples.dtype, np.number) or np.issubdtype(
            samples.dtype, np.complexfloating
        ):
            raise TypeError(f"samples must be real numeric, got {samples.dtype}")
        self._submit(("feed", handle, samples, None), "feed")

    def close_session(self, handle: int) -> None:
        """Drain + finalize a session (blocking until flushed); its result
        queue then ends."""
        fut = Future()
        self._submit(("close", handle, fut), "close_session")
        fut.result()

    def iter_results(self, handle: int):
        """Yield feature blocks for a session until its close flush.

        Safe to run concurrently with :meth:`feed`; re-raises any device
        error that failed the session.
        """
        if self._relay is not None and not self._relay.front:
            raise _follower_error("iter_results")
        with self._lock:
            q = self._results.get(handle)
        if q is None:
            raise KeyError(f"no session {handle}")
        while True:
            item = q.get()
            if item is None:
                with self._lock:
                    self._results.pop(handle, None)
                return
            if isinstance(item, BaseException):
                # an error ends this result stream: drop the queue so a
                # retry raises KeyError instead of blocking forever on a
                # queue nothing will feed again
                with self._lock:
                    self._results.pop(handle, None)
                raise item
            yield item

    def close(self) -> None:
        """Stop the loop; unclosed sessions' queues end with an error.  On
        a follower, waits until the front's close reaches it."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._cmds.put(None)
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- loop thread -------------------------------------------------------

    def _submit(self, cmd, name: str) -> None:
        if self._relay is not None and not self._relay.front:
            raise _follower_error(name)
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._cmds.put(cmd)

    def _queue_of(self, handle):
        with self._lock:
            return self._results.get(handle)

    def _handle(self, cmd) -> None:
        """Apply one command (its last item is its future, None on a
        follower) to the pool."""
        kind, fut = cmd[0], cmd[-1]
        if kind == "warmup":
            _, depths, occupancies, _ = cmd
            pool = self._pool
            try:
                pool.warmup(depths, occupancies)
                if self._relay is not None:
                    # the slot gather's first call (seconds on a card) too
                    pool._gathered(*pool._stream._finalize_impl(pool._states))
            except Exception as e:  # noqa: BLE001 -- to the caller
                _settle(fut, exc=e)
                return
            _settle(fut)
        elif kind == "open":
            try:
                handle = self._pool.open()
            except Exception as e:  # noqa: BLE001 -- to the caller
                _settle(fut, exc=e)
                return
            if fut is not None:
                with self._lock:
                    self._results[handle] = queue.SimpleQueue()
            _settle(fut, handle)
        elif kind == "feed":
            _, handle, samples, _ = cmd
            try:
                self._pool.feed(handle, samples)
            except KeyError:
                pass  # fed after close: drop (the stream already ended)
            except Exception as e:  # noqa: BLE001 -- fail the one session
                # feed() pre-validates, so this is unexpected -- but it must
                # never kill the loop thread (every other session would
                # hang); deliver it to the session instead
                q = self._queue_of(handle)
                if q is not None:
                    q.put(e)
        elif kind == "close":
            # queues may already be gone (iter_results drops a session's
            # queue on a delivered error) -- never index unconditionally
            _, handle, _ = cmd
            try:
                for h, feats in self._pool.close_many([handle]):
                    q = self._queue_of(h)
                    if q is not None:
                        q.put(feats)
            except Exception as e:  # noqa: BLE001 -- to the caller
                q = self._queue_of(handle)
                if q is not None:
                    q.put(e)
                _settle(fut, exc=e)
                return
            q = self._queue_of(handle)
            if q is not None:
                q.put(None)
            _settle(fut)

    def _run(self) -> None:
        with _device_scope(self._device):
            try:
                self._loop()
            finally:
                if self._relay is not None:
                    self._relay.send_obj(None)  # the followers' stop

    def _loop(self) -> None:
        sessions = self._pool._sessions  # loop-thread only
        while True:
            have_pending = any(len(s.pending) for s in sessions.values())
            try:
                cmd = self._cmds.get(timeout=self._wait if have_pending else None)
            except queue.Empty:
                cmd = False  # timeout: tick with what we have
            if cmd is None:
                with self._lock:
                    live = list(self._results.items())
                for handle, q in live:
                    if handle in sessions:
                        q.put(RuntimeError("server is closed"))
                return
            cmds = []
            if cmd is not False:
                cmds.append(cmd)
                # drain any further queued commands before device work
                while True:
                    try:
                        nxt = self._cmds.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._cmds.put(None)  # re-queue the stop
                        break
                    cmds.append(nxt)
            if self._relay is not None:
                self._relay.send_obj(([c[:-1] for c in cmds], self._tick_chunks))
            for c in cmds:
                self._handle(c)
            self._tick(self._tick_chunks)

    def _follow(self) -> None:
        """A follower's loop: apply the front's commands to this rank's
        pool in the front's order and tick, until the front stops."""
        with _device_scope(self._device):
            while True:
                msg = self._relay.recv_obj()
                if msg is None:
                    return
                cmds, max_chunks = msg
                for c in cmds:
                    self._handle((*c, None))
                self._tick(max_chunks)

    def _tick(self, max_chunks: int) -> None:
        sessions = self._pool._sessions
        involved = [h for h, s in sessions.items() if len(s.pending)]
        err = None
        try:
            outs = self._pool.step(max_chunks=max_chunks)
        except Exception as e:  # noqa: BLE001 -- fail live sessions
            err = e
        if self._relay is not None and involved and not self._relay.agree(err is None):
            err = err or RuntimeError("the tick failed on another rank")
        if err is not None:
            # a failed tick fails the sessions involved TERMINALLY: deliver
            # the exception once and drop their backlogs -- retrying the
            # same backlog would re-raise every max_wait_ms forever.  The
            # sessions stay open: close_session still finalizes from the
            # last good state.
            for handle in involved:
                sessions[handle].pending = sessions[handle].pending[:0]
                q = self._queue_of(handle)
                if q is not None:
                    q.put(err)
            return
        for handle, feats in outs:
            q = self._queue_of(handle)
            if q is not None:
                q.put(feats)
