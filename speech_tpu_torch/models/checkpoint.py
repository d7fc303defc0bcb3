"""Train-state checkpoint/resume for the model families.

The counterpart of :mod:`speech_tpu.models.checkpoint`, on
:func:`torch.save` / :func:`torch.load` in place of orbax.  Resuming an
interrupted training run needs the parameters, the optimizer state, the
step counter and any loop metadata, written atomically, rotated, and
restorable onto a given device:

- ``TrainCheckpointer(directory).save(step, model, optimizer, extra=...)``
  writes one checkpoint per step (``directory/<step>/state.pt``, written
  under a temporary name and renamed into place, so that a crash never
  leaves a half-written step) and keeps the newest ``max_to_keep``.
- ``restore(like=(model, optimizer))`` loads the latest (or a given) step
  into the template's module and optimizer (``load_state_dict``; state
  dicts come back as they are, on ``device``).  ``restore_params`` loads
  the parameters alone, with no optimizer in sight.

What is saved: ``state_dict()`` of anything that has one (a module, an
optimizer, an LR scheduler), nested dicts, lists and tuples of them,
tensors, and plain Python scalars and strings.  Files are read with
``torch.load(weights_only=True)``, which refuses numpy arrays and
arbitrary objects: pass ``extra`` as tensors and Python scalars.

These checkpoints are torch files, not orbax's: the JAX package cannot
read them, nor this one the JAX package's.  Parameters cross between the
packages through the ``.npz`` files of ``save_params`` / ``load_params``.

Saves are synchronous by default (``save`` returns once the step is on
disk); ``async_save=True`` copies the state to host memory, returns, and
writes on a background thread -- call :meth:`TrainCheckpointer.wait`
before relying on the files.
"""

import os
import queue
import shutil
import tempfile
import threading
from typing import Any, Optional, Tuple

import torch

__all__ = ["TrainCheckpointer"]

_FILE = "state.pt"


def _state(obj):
    """The savable state of ``obj``: its ``state_dict()`` where it has one,
    else the same structure with each such leaf replaced."""
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    if isinstance(obj, dict):
        return {k: _state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_state(v) for v in obj)
    return obj


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _to_host(tree):
    """A copy of ``tree`` in host memory (an async save must not see the
    next training step's in-place updates)."""
    return _map(lambda t: t.detach().to("cpu", copy=True), tree)


def _load_into(like, state, device):
    """``state`` loaded into ``like``'s stateful objects (returned), or,
    where ``like`` holds no such object, ``state`` itself moved to
    ``device``."""
    if hasattr(like, "load_state_dict"):
        like.load_state_dict(state)
        return like
    if isinstance(like, dict) and isinstance(state, dict):
        return {k: _load_into(like.get(k), v, device) for k, v in state.items()}
    if isinstance(like, (list, tuple)) and isinstance(state, (list, tuple)):
        return type(state)(_load_into(a, b, device) for a, b in zip(like, state))
    if device is not None:
        return _map(lambda t: t.to(device), state)
    return state


class TrainCheckpointer:
    """Rotated, resumable train-state checkpoints in ``directory``.

    The saved state is the pair that training threads through the steps --
    the model's parameters and the optimizer state -- plus an optional
    ``extra`` of loop metadata (epoch, data cursor, generator state, ...).
    """

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = False):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._async = bool(async_save)
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._jobs: Optional[queue.Queue] = None
        self._writer: Optional[threading.Thread] = None
        if self._async:
            self._jobs = queue.Queue()
            self._writer = threading.Thread(
                target=self._write_loop, name="speech-tpu-checkpoint", daemon=True
            )
            self._writer.start()

    # -- writing -------------------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any, extra: Any = None) -> None:
        """Write one checkpoint for ``step`` (atomic; rotates old steps).

        ``params`` and ``opt_state`` are modules, optimizers, schedulers,
        state dicts, or dicts/lists of them; ``extra`` holds tensors and
        Python scalars."""
        self._raise_pending()
        state = {"params": _state(params), "opt_state": _state(opt_state)}
        if extra is not None:
            state["extra"] = _state(extra)
        if self._async:
            self._jobs.put((int(step), _to_host(state)))
        else:
            self._write(int(step), state)

    def wait(self) -> None:
        """Block until every pending async save is on disk (re-raises a
        failed one)."""
        if self._jobs is not None:
            self._jobs.join()
        self._raise_pending()

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _write_loop(self):
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                self._write(*job)
            except BaseException as e:  # noqa: BLE001 -- to wait() / save()
                with self._lock:
                    self._error = e
            finally:
                self._jobs.task_done()

    def _write(self, step: int, state: dict) -> None:
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
        try:
            torch.save(state, os.path.join(tmp, _FILE))
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self._max_to_keep is not None:
            for old in self.all_steps()[: -self._max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    # -- reading -------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self):
        """Steps currently on disk (oldest first), after rotation."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, _FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """Newest saved step, or ``None`` if the directory has none."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self._step_dir(step), _FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint for step {step} under {self.directory}")
        return int(step), torch.load(path, map_location="cpu", weights_only=True)

    def restore(
        self,
        like: Tuple[Any, Any],
        step: Optional[int] = None,
        extra_like: Any = None,
        device=None,
    ):
        """Load ``(step, params, opt_state, extra)`` from disk.

        ``like`` is a ``(params, opt_state)`` template: a module and an
        optimizer (or scheduler, or dicts/lists of them) are loaded in
        place with ``load_state_dict`` and returned; a template with no
        such object (``None``, a dict of tensors) gets the saved state
        dicts back, moved to ``device``.  Modules keep their device, and
        an optimizer casts its state to its parameters' devices.
        ``extra_like`` mirrors the ``extra`` passed to :meth:`save`; the
        saved ``extra`` comes back (on ``device``) whether it is given or
        not.  ``step=None`` restores the latest.
        """
        self.wait()
        step, state = self._load(step)
        if extra_like is not None and "extra" not in state:
            raise ValueError(
                f"extra_like was passed but checkpoint step {step} was "
                "saved without an 'extra' (save(..., extra=...) was not "
                "used); omit extra_like to restore it"
            )
        params = _load_into(like[0], state["params"], device)
        opt_state = _load_into(like[1], state["opt_state"], device)
        extra = state.get("extra")
        if extra is not None:
            extra = _load_into(extra_like, extra, device)
        return step, params, opt_state, extra

    def restore_params(self, like: Any, step: Optional[int] = None, device=None):
        """Load only the trained parameters (for serving/eval hand-off):
        into the module ``like`` (returned), or as a state dict on
        ``device`` where ``like`` is ``None``.  No optimizer is needed."""
        self.wait()
        _, state = self._load(step)
        return _load_into(like, state["params"], device)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Finish pending saves and stop the writer thread."""
        if self._writer is not None:
            self._jobs.put(None)
            self._writer.join()
            self._writer = None
            self._jobs = None
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
