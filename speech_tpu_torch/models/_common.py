"""Shared building blocks for the model families.

The counterpart of :mod:`speech_tpu.models._common`.  One home for the
invariants every family relies on, so they cannot drift across copies:

- the length-independent explicit conv padding (logits/embeddings must be
  invariant to how far a batch was padded),
- per-layer re-zeroing of rows at or past the valid count,
- the generic optimizer step (``loss.backward`` -> gradient mean over a
  data-parallel group -> ``optimizer.step``),
- the parameter trees: every learnable leaf is a
  :class:`~torch.nn.Parameter` whose dotted name is the JAX package's
  ``"/"``-joined ``params`` key, in the JAX package's layout (``(W, I, O)``
  conv kernels, ``(d, h, k)`` attention projections), so that a
  checkpoint of either package loads in the other without transposes.

Products run inside :func:`~speech_tpu_torch.ops.stft.ieee_float32` (IEEE
float32, the reference's ``Precision.HIGHEST``; cuDNN and cuBLAS would
otherwise take TF32 on Hopper), and so does :func:`make_train_step`'s
backward, whose gradient convolutions launch after the forward's blocks
have exited.
"""

import copy
import math
import os
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops._device import resolve_device
from ..ops.stft import ieee_float32
from ..streaming import StreamingSTFT, _counts, _drop, _lift, _window

__all__ = [
    "valid_mask",
    "he_conv_init",
    "masked_conv_block",
    "make_train_step",
    "SlidingWindowStream",
    "WindowState",
    "params_from_jax",
]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype).name]


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The draws' source: ``generator``, else a fresh CPU generator seeded
    with 0 (the reference's ``PRNGKey(0)`` default of its tests)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return generator


def _normal(generator, shape, dtype, device, scale: float) -> torch.Tensor:
    """``scale`` times standard normal draws of ``shape``, drawn on the
    generator's device and moved to ``device``."""
    x = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    return (x * scale).to(device)


class ParamTree(torch.nn.Module):
    """A nested dict of tensors as a module: dict values become child
    trees, tensors become :class:`~torch.nn.Parameter` s, under the same
    keys.  ``tree.w``, ``tree.conv0.b``; ``tree["w"]`` too."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(key, torch.nn.Parameter(value))

    def __getitem__(self, key):
        return getattr(self, key)


def valid_mask(total: int, counts):
    """Boolean ``(batch, total)`` marking rows before each valid count."""
    return torch.arange(total, device=counts.device)[None, :] < counts[:, None]


def he_conv_init(generator, kernel_width: int, fan_in_dim: int, out_c: int, dtype,
                 device=None) -> ParamTree:
    """He-normal ``(W, I, O)`` conv kernel ``w`` + zero bias ``b``, drawn
    from ``generator`` (a :class:`torch.Generator`; ``None`` seeds one
    with 0) and placed on ``device`` (default: the GPU)."""
    dtype, device = _dtype(dtype), resolve_device(device)
    w = _normal(_generator(generator), (kernel_width, fan_in_dim, out_c), dtype, device,
                math.sqrt(2.0 / (kernel_width * fan_in_dim)))
    return ParamTree({"w": w, "b": torch.zeros(out_c, dtype=dtype, device=device)})


def _ceil_div(counts, stride: int):
    return -torch.div(-counts, stride, rounding_mode="floor")


def masked_conv_block(x, block, counts, stride: int = 1, dilation: int = 1):
    """One ``(batch, T, C)`` conv + relu(+bias) with padding-proof
    semantics.

    Explicit, length-independent padding ``(span // 2, span - span // 2)``
    keeps ``out[j]`` centered at ``in[j*stride]`` for any padded buffer
    length (``conv1d``'s own ``padding=`` is symmetric and cannot express
    an odd span), and rows at or past the stride-propagated valid count
    are re-zeroed.  ``block`` holds the ``(W, I, O)`` kernel ``w`` and the
    bias ``b``.  Returns ``(x, counts)`` for the next layer; the counts
    stay on the device.
    """
    w = block["w"]
    span = dilation * (w.shape[0] - 1)
    padded = F.pad(x.transpose(1, 2), (span // 2, span - span // 2))
    with ieee_float32():
        y = F.conv1d(padded, w.permute(2, 1, 0), stride=stride, dilation=dilation)
    y = torch.relu(y.transpose(1, 2) + block["b"])
    counts = _ceil_div(counts, stride)
    y = torch.where(valid_mask(y.shape[1], counts)[..., None], y, 0)
    return y, counts


def _as_counts(lengths, batch: int, total: int, device) -> torch.Tensor:
    """Valid counts ``(batch,)`` int64 on ``device``; ``None`` is all of
    ``total``."""
    if lengths is None:
        return torch.full((batch,), total, dtype=torch.int64, device=device)
    if isinstance(lengths, torch.Tensor):
        return lengths.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(lengths), dtype=torch.int64, device=device)


def _as_input(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _frontend_dim(frontend) -> int:
    """Feature dimension produced by a :mod:`speech_tpu_torch.nn` frontend."""
    dim = getattr(frontend, "num_coeffs", None)
    if dim is None:
        dim = getattr(frontend, "num_filts", None)
    if dim is None:
        raise ValueError(
            "frontend exposes neither num_coeffs nor num_filts; pass "
            "feature_dim explicitly"
        )
    return int(dim)


def _frontend_device(frontend) -> torch.device:
    for t in list(frontend.parameters()) + list(frontend.buffers()):
        return t.device
    return resolve_device(None)


class _FrontendModel(torch.nn.Module):
    """A frontend feeding a head network: the frontend's features and
    valid frame counts, with its output detached when it is frozen
    (``train_frontend=False``: its gradients stay ``None``)."""

    def _init_frontend(self, frontend, train_frontend: bool, dtype):
        self.frontend = frontend
        self.train_frontend = bool(train_frontend)
        self.dtype = _dtype(dtype) if dtype is not None else frontend.dtype
        self.device = _frontend_device(frontend)

    def _features(self, signals, lengths):
        signals = _as_input(signals, self.dtype, self.device)
        lengths = _as_counts(lengths, signals.shape[0], signals.shape[-1], self.device)
        feats = self.frontend(signals, lengths)
        if not self.train_frontend:
            feats = feats.detach()
        counts = self.frontend.frame_counts(lengths).to(self.device)
        return feats.to(self.dtype), counts


def _snapshot(module: torch.nn.Module) -> torch.nn.Module:
    """A frozen copy of ``module``'s parameters as they are now (a stream
    scores with these; later training of the model does not move it)."""
    out = copy.deepcopy(module)
    out.requires_grad_(False)
    return out


# --- parameter trees across packages ------------------------------------------


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + "/")
        else:
            yield path, val


def _unflatten(flat: Mapping) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return out


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def params_from_jax(module: torch.nn.Module, params) -> dict:
    """Load the JAX package's nested ``params`` dict of a model (numpy or
    jax leaves), or the path of an ``.npz`` written by either package's
    ``save_params``, into ``module``.

    Keys are the ``"/"``-joined paths of the parameters' dotted names and
    layouts are the JAX package's own, so nothing is transposed; the copy
    is :func:`speech_tpu_torch.nn.params_from_jax`'s.  The keys must be
    exactly the module's parameters.  Returns the parameters by their
    ``"/"`` keys."""
    from .. import nn as _nn

    if isinstance(params, (str, os.PathLike)):
        with np.load(params) as data:
            params = {k: data[k] for k in data.files}  # already "/"-joined
    own = _nn.params_from_jax(
        module, {k.replace("/", "."): _host(v) for k, v in _flatten(params)})
    return {name.replace(".", "/"): p for name, p in own.items()}


def save_params(wfilename: str, params) -> None:
    """Checkpoint a model's parameters (a module, or a nested dict of
    arrays as the JAX package's ``params``) to one ``.npz`` file keyed by
    the ``"/"``-joined paths, as the JAX package's ``save_params`` writes
    it."""
    if isinstance(params, torch.nn.Module):
        flat = {name.replace(".", "/"): p for name, p in params.named_parameters()}
    else:
        flat = dict(_flatten(params))
    np.savez(wfilename, **{k: _host(v) for k, v in flat.items()})


def load_params(rfilename: str, module: Optional[torch.nn.Module] = None, dtype=None):
    """Load a checkpoint written by :func:`save_params` of either package.

    With ``module``, the parameters are loaded into it (see
    :func:`params_from_jax`) and the module is returned; without, the
    nested dict of numpy arrays (cast to ``dtype`` where given)."""
    if module is not None:
        params_from_jax(module, rfilename)
        return module
    with np.load(rfilename) as data:
        flat = {
            k: data[k] if dtype is None else data[k].astype(np.dtype(dtype))
            for k in data.files
        }
    return _unflatten(flat)


# --- training -----------------------------------------------------------------


def make_train_step(model, optimizer, group=None):
    """The optimizer step of any model family.

    ``step(*batch) -> metrics``, where ``*batch`` is whatever
    ``model.loss(*batch)`` takes (KWS/speaker: ``signals, lengths,
    labels``; CTC adds ``label_lengths``): the loss's gradients, then
    ``optimizer.step()`` and ``optimizer.zero_grad()``.  The loss and its
    backward run in IEEE float32 (:func:`~speech_tpu_torch.ops.stft.ieee_float32`);
    a caller who runs ``loss.backward()`` itself wraps it the same way, or
    gets PyTorch's defaults (TF32 convolutions on the card).  ``metrics``
    carries ``"loss"``, plus ``"accuracy"`` when the family's aux provides
    one, as detached tensors (nothing is read back to the host).

    Data parallelism: with a :mod:`torch.distributed` ``group`` of more
    than one process, each process passes its own equal block of the
    batch's rows; the gradients (and the metrics) are averaged over the
    group before the step, which is the full batch's mean-loss gradient,
    as XLA's inserted all-reduce makes it on the JAX package's data mesh.
    """
    world = 1 if group is None else dist.get_world_size(group)

    def mean(t):
        if world > 1:
            dist.all_reduce(t, group=group)
            t.div_(world)
        return t

    def step(*batch):
        # the backward's convolutions and products (input and weight
        # gradients) are launched here, after the forward's blocks have
        # exited: IEEE float32 for them too
        with ieee_float32():
            loss, aux = model.loss(*batch)
            loss.backward()
        for p in model.parameters():
            if p.grad is not None:
                mean(p.grad)
        optimizer.step()
        optimizer.zero_grad()
        metrics = {"loss": mean(loss.detach().clone())}
        if "accuracy" in aux:
            metrics["accuracy"] = mean(aux["accuracy"].detach().clone())
        return metrics

    return step


# --- sliding-window streams ---------------------------------------------------


class WindowState(NamedTuple):
    """Carry of a :class:`SlidingWindowStream`: the feature stream's state,
    the ring of the last ``window_frames`` frames and the frames seen."""

    stft: tuple
    ring: torch.Tensor  # (window_frames, num_coeffs)
    count: torch.Tensor  # int64, frames emitted so far


class SlidingWindowStream:
    """Chunked frontend -> ring of the last ``window_frames`` frames ->
    a per-tick score over the masked window.

    The shared machinery behind online model deployment
    (:class:`~speech_tpu_torch.models.kws.StreamingKWS` scores classifier
    logits; :class:`~speech_tpu_torch.models.speaker.StreamingSpeaker`
    scores embeddings).  The ring update and the window re-alignment are
    one gather each (``arange + offset``, per stream), and fewer-than-
    window frames mask exactly like the batch path, so once
    ``window_frames`` covers the whole utterance the finalize-tick score
    equals the batch model on the full signal to roundoff.

    Subclasses implement ``_score(window (S, W, C), v (S,)) -> (S, K)``
    over left-aligned windows with ``v`` valid leading rows.

    Honours the :class:`~speech_tpu_torch.serve.StreamPool` streamer
    contract (``init_state`` / ``_process_impl`` / ``_finalize_impl``,
    where a step with 0 valid samples leaves the state bitwise unchanged)
    and the port's leading stream axis: ``init_state(streams=S)`` and
    ``(S, C)`` chunks tick S sessions in one call, each emitting one
    ``(1, K)`` score row for the window after its newly consumed audio.
    A tick queues no host synchronisation.
    """

    def __init__(self, computer, *, window_frames: int, chunk_size: int, dtype):
        if window_frames < 1:
            raise ValueError(f"window_frames must be positive, got {window_frames}")
        self.window_frames = int(window_frames)
        self._stream = StreamingSTFT(computer, chunk_size)
        self.chunk_size = self._stream.chunk_size
        self.num_coeffs = int(computer.num_coeffs)
        self._dtype = _dtype(dtype)
        self.device = self._stream.device

    def _score(self, window, v):
        raise NotImplementedError  # pragma: no cover - subclass contract

    def init_state(self, streams=None) -> WindowState:
        """A fresh state; ``streams`` gives every leaf a leading axis."""
        lead = () if streams is None else (int(streams),)
        return WindowState(
            stft=self._stream.init_state(streams),
            ring=torch.zeros(lead + (self.window_frames, self.num_coeffs),
                             dtype=self._dtype, device=self.device),
            count=torch.zeros(lead, dtype=torch.int64, device=self.device),
        )

    def _tick(self, ring, count, feats, n):
        """Streams ``ring (S, W, C)``, ``count (S,)``, new rows ``feats (S,
        M, C)`` of which ``n (S,)`` are valid: the new ring, count and
        score ``(S, K)``."""
        W = self.window_frames
        appended = torch.cat([ring, feats.to(self._dtype)], dim=1)
        # rows [W + n, W + M) of `appended` are garbage emitted past the
        # valid count; the new ring [n, n + W) ends at the last valid row,
        # and the scoring window is left-aligned so the score's first-v-rows
        # mask matches the batch semantics
        ring = _window(appended, n, W)
        count = count + n
        v = torch.clamp(count, max=W)
        # left-align the v valid rows (the ring's tail); the zero extension
        # keeps the slice in bounds for every v without clamping
        padded = torch.cat([ring, torch.zeros_like(ring)], dim=1)
        window = _window(padded, W - v, W)
        with torch.no_grad():
            score = self._score(window, v)
        return ring, count, score

    def _lifted(self, state):
        single = state.count.dim() == 0
        if single:
            state = WindowState(*(_lift(x) for x in state))
        return state, single

    def process(self, state: WindowState, chunk, valid_len=None):
        """Feed one ``(chunk_size,)`` chunk (``(S, chunk_size)`` on the
        stream axis); returns ``(state, score)`` for the new window."""
        if chunk.shape[-1] != self.chunk_size:
            raise ValueError(
                f"chunk must have static size {self.chunk_size}; got {chunk.shape[-1]}"
            )
        if valid_len is None:
            valid_len = self.chunk_size
        state, score, _ = self._process_impl(state, chunk, valid_len)
        return state, score[..., 0, :]

    def finalize(self, state: WindowState):
        """Flush the stream tail; returns the final-window score."""
        fin, n = self._finalize_impl(state)
        return fin[..., 0, :]

    # -- StreamPool streamer contract ---------------------------------------

    def _process_impl(self, state: WindowState, chunk, valid_len):
        stft, feats, n = self._stream._process_impl(state.stft, chunk, valid_len)
        state, single = self._lifted(WindowState(stft, state.ring, state.count))
        if single:
            feats, n = feats[None], n[None]
        ring, count, score = self._tick(state.ring, state.count, feats, n)
        # a 0-valid step leaves ring/count bitwise unchanged (the ring
        # gather at offset 0; count + 0) and emits no row
        v = _counts(valid_len, ring.shape[0], 1, ring.device)
        out = (WindowState(state.stft, ring, count), score[:, None], v)
        return tuple(_drop(x) for x in out) if single else out

    def _finalize_impl(self, state: WindowState):
        feats, n = self._stream._finalize_impl(state.stft)
        state, single = self._lifted(state)
        if single:
            feats, n = feats[None], n[None]
        _, _, score = self._tick(state.ring, state.count, feats, n)
        ones = torch.ones(score.shape[0], dtype=torch.int64, device=score.device)
        out = (score[:, None], ones)
        return tuple(_drop(x) for x in out) if single else out

