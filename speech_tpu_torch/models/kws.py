"""Keyword-spotting model family: trainable frontend -> conv encoder -> head.

The counterpart of :mod:`speech_tpu.models.kws`, as
:class:`torch.nn.Module` s: a small utterance classifier whose first layer
is any of the learnable frontends in :mod:`speech_tpu_torch.nn`
(folded-STFT, LEAF-style Gabor, SincNet-style band edges).  ``forward`` is
the JAX package's ``apply`` without ``params`` and ``consts``; the
parameters carry the JAX ``params`` keys as their dotted names
(``classifier.conv0.w`` is ``classifier/conv0/w``), in its layouts.

- The encoder is a stack of strided 1-D convolutions over the frame axis
  (``conv1d`` on cuDNN, in IEEE float32), shrinking the frame axis
  geometrically.
- Ragged batches: padded feature rows are zero-masked before the encoder
  and the final pooling divides by the *valid* (stride-propagated) frame
  count, so padding never leaks into the logits.
- The frontend can be frozen (``train_frontend=False``): its output is
  detached, so its parameters get no gradient.

Random initial values come from a :class:`torch.Generator` (``None``: a
CPU generator seeded with 0); they follow the JAX package's laws (He-normal
convs, zero head), not its draws.  :func:`~speech_tpu_torch.models.params_from_jax`
carries the JAX package's values across.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ._common import (
    ParamTree,
    SlidingWindowStream,
    _FrontendModel,
    _as_counts,
    _as_input,
    _dtype,
    _frontend_dim,
    _generator,
    _snapshot,
    he_conv_init,
    load_params,
    make_train_step,
    masked_conv_block,
    params_from_jax,
    save_params,
    valid_mask,
)
from ..ops._device import resolve_device
from ..ops.stft import ieee_float32

__all__ = [
    "ConvClassifier",
    "KWSModel",
    "StreamingKWS",
    "make_train_step",
    "params_from_jax",
    "save_params",
    "load_params",
]


class ConvClassifier(torch.nn.Module):
    """Strided 1-D conv encoder + masked mean pool + linear head.

    ``logits = clf(feats, num_frames)`` with ``feats`` shaped ``(batch,
    max_frames, feature_dim)``.  Parameters ``conv{i}.w`` ``(W, I, O)``,
    ``conv{i}.b``, ``head.w`` ``(C, num_classes)`` and ``head.b``.

    Parameters
    ----------
    feature_dim
        Input feature dimension (frontend coefficients per frame).
    num_classes
        Output logit count.
    channels
        Output channels of each conv block.
    kernel_width
        Temporal kernel width shared by all blocks.
    strides
        Temporal stride per block (defaults to 2 for every block).
    dtype, device
        Parameter / activation dtype, and where the module lives (default:
        the GPU).
    generator
        The :class:`torch.Generator` of the initial values.
    """

    def __init__(
        self,
        feature_dim: int,
        num_classes: int,
        channels: Sequence[int] = (64, 64),
        kernel_width: int = 5,
        strides: Optional[Sequence[int]] = None,
        dtype=torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if num_classes < 2:
            raise ValueError(f"num_classes must be >= 2, got {num_classes}")
        if kernel_width < 1:
            raise ValueError(f"kernel_width must be >= 1, got {kernel_width}")
        self.feature_dim = int(feature_dim)
        self.num_classes = int(num_classes)
        self.channels = tuple(int(c) for c in channels)
        if strides is None:
            strides = (2,) * len(self.channels)
        self.strides = tuple(int(s) for s in strides)
        if len(self.strides) != len(self.channels):
            raise ValueError(
                f"strides ({len(self.strides)}) and channels "
                f"({len(self.channels)}) must have equal length"
            )
        if any(s < 1 for s in self.strides):
            raise ValueError(f"strides must be >= 1, got {self.strides}")
        self.kernel_width = int(kernel_width)
        self.dtype = _dtype(dtype)
        device = resolve_device(device)
        generator = _generator(generator)
        fan_in_dim = self.feature_dim
        for i, out_c in enumerate(self.channels):
            self.add_module(
                f"conv{i}",
                he_conv_init(generator, self.kernel_width, fan_in_dim, out_c, self.dtype, device),
            )
            fan_in_dim = out_c
        # zero head: initial logits are exactly uniform
        self.head = ParamTree({
            "w": torch.zeros((fan_in_dim, self.num_classes), dtype=self.dtype, device=device),
            "b": torch.zeros(self.num_classes, dtype=self.dtype, device=device),
        })

    def out_frames(self, num_frames):
        """Valid frame count after all strides (``SAME`` padding: ceil)."""
        for s in self.strides:
            num_frames = -(-num_frames // s)
        return num_frames

    def forward(self, feats, num_frames=None):
        """Logits ``(batch, num_classes)`` for ``(batch, T, F)`` features.

        ``num_frames`` are the valid per-example frame counts; rows at or
        past a count are zeroed before the encoder and excluded from the
        mean pool, so padded rows cannot influence the logits.
        """
        feats = _as_input(feats, self.dtype, self.head.w.device)
        if feats.dim() != 3:
            raise ValueError(f"feats must be (batch, T, F), got {tuple(feats.shape)}")
        total = feats.shape[1]
        valid = _as_counts(num_frames, feats.shape[0], total, feats.device)
        x = torch.where(valid_mask(total, valid)[..., None], feats, 0)
        for i, stride in enumerate(self.strides):
            x, valid = masked_conv_block(x, getattr(self, f"conv{i}"), valid, stride=stride)
        # masked mean pool over the surviving frame axis
        denom = torch.clamp_min(valid, 1).to(x.dtype)[:, None]
        pooled = torch.sum(x, dim=1) / denom
        with ieee_float32():
            return pooled @ self.head.w + self.head.b


class KWSModel(_FrontendModel):
    """A frontend + :class:`ConvClassifier`, trained end to end.

    ``frontend`` is any :mod:`speech_tpu_torch.nn` module with the
    ``frontend(signals, lengths)`` / ``frame_counts(lengths)`` contract
    (:class:`~speech_tpu_torch.nn.STFTFrontend`,
    :class:`~speech_tpu_torch.nn.GaborFrontend`,
    :class:`~speech_tpu_torch.nn.SincFrontend`)::

        model = KWSModel(frontend, num_classes=10)
        logits = model(signals, lengths)
        loss, aux = model.loss(signals, lengths, labels)

    Submodules ``frontend`` and ``classifier`` (the JAX ``params`` keys);
    the model lives on the frontend's device.  ``train_frontend=False``
    freezes the frontend (its gradients stay ``None``).
    """

    def __init__(
        self,
        frontend,
        num_classes: int,
        channels: Sequence[int] = (64, 64),
        kernel_width: int = 5,
        strides: Optional[Sequence[int]] = None,
        train_frontend: bool = True,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self._init_frontend(frontend, train_frontend, dtype)
        self.classifier = ConvClassifier(
            _frontend_dim(frontend),
            num_classes,
            channels=channels,
            kernel_width=kernel_width,
            strides=strides,
            dtype=self.dtype,
            device=self.device,
            generator=generator,
        )

    @property
    def num_classes(self) -> int:
        return self.classifier.num_classes

    def forward(self, signals, lengths=None):
        """Logits ``(batch, num_classes)`` for padded ``(batch, S)`` signals."""
        feats, counts = self._features(signals, lengths)
        return self.classifier(feats, counts)

    def loss(self, signals, lengths, labels):
        """Mean softmax cross-entropy plus accuracy, as ``(loss, aux)``."""
        logits = self(signals, lengths)
        labels = _as_counts(labels, logits.shape[0], 0, logits.device)
        log_p = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(log_p, 1, labels[:, None])[:, 0]
        acc = (torch.argmax(logits, dim=-1) == labels).to(log_p.dtype).mean()
        return nll.mean(), {"accuracy": acc, "logits": logits}


class StreamingKWS(SlidingWindowStream):
    """Online sliding-window scoring of a trained :class:`KWSModel`.

    The trained STFT frontend is baked into a computer
    (:meth:`~speech_tpu_torch.nn.STFTFrontend.export_computer`) whose
    :class:`~speech_tpu_torch.streaming.StreamingSTFT` emits features chunk
    by chunk; a ring of the last ``window_frames`` frames is re-scored by
    a snapshot of the conv classifier on every tick.  Once
    ``window_frames`` covers the whole utterance the finalize-tick logits
    equal ``model`` on the full signal to roundoff.  See
    :class:`~speech_tpu_torch.models._common.SlidingWindowStream` for the
    tick and the :class:`~speech_tpu_torch.serve.StreamPool` contract.

    Needs a frontend with ``export_computer`` (an
    :class:`~speech_tpu_torch.nn.STFTFrontend`); the Gabor/Sinc frontends
    train in :class:`KWSModel` but have no streaming export.

    Example::

        skws = StreamingKWS(model, window_frames=100, chunk_size=1600)
        state = skws.init_state()
        for chunk in chunks:                    # (1600,) each
            state, logits = skws.process(state, chunk)
        logits = skws.finalize(state)           # flushes the stream tail
    """

    def __init__(self, model: KWSModel, *, window_frames: int, chunk_size: int):
        if not hasattr(model.frontend, "export_computer"):
            raise ValueError(
                "StreamingKWS needs a frontend with export_computer (an "
                "STFTFrontend); "
                f"{type(model.frontend).__name__} has no streaming export"
            )
        self.model = model
        # the parameters as they are now: later training moves neither the
        # exported computer nor the classifier the ticks score with
        self._classifier = _snapshot(model.classifier)
        super().__init__(
            model.frontend.export_computer(),
            window_frames=window_frames,
            chunk_size=chunk_size,
            dtype=model.dtype,
        )
        if self.num_coeffs != model.classifier.feature_dim:
            raise ValueError(
                f"classifier expects {model.classifier.feature_dim} "
                f"coefficients, computer produces {self.num_coeffs}"
            )

    def _score(self, window, v):
        return self._classifier(window, v)

