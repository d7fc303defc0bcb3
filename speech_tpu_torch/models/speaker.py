"""Speaker-embedding model family: frontend -> TDNN -> stats pool -> embed.

The counterpart of :mod:`speech_tpu.models.speaker`, as
:class:`torch.nn.Module` s: an x-vector-style TDNN encoder (Snyder et al.
2018) over the frame axis on any :mod:`speech_tpu_torch.nn` frontend,
masked statistics pooling (mean + std over valid frames), a linear
embedding layer, and an additive-angular-margin softmax (ArcFace, Deng et
al. 2019) training head.  Parameters carry the JAX ``params`` keys as
their dotted names, in its layouts.

- The TDNN layers are dilated stride-1 1-D convolutions (``conv1d``, IEEE
  float32) over the whole padded batch.
- Ragged batches: every layer re-zeros rows at or past the valid frame
  count, and the pooling moments divide by the valid count, so padding
  never leaks into an embedding.
- The AAM head's trig comes from the cosine directly (``sin = sqrt(1 -
  cos^2)``), with a ``1e-12`` floor under the sqrt so that its gradient
  stays finite at cosines of exactly +/-1.
"""

import math
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
    _normal,
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
    "TDNNEncoder",
    "SpeakerModel",
    "StreamingSpeaker",
    "aam_softmax_loss",
    "cosine_scores",
    "make_train_step",
    "params_from_jax",
    "save_params",
    "load_params",
]


class TDNNEncoder(torch.nn.Module):
    """Dilated stride-1 conv stack over frames, with valid-length masking.

    ``hidden = enc(feats, num_frames)`` maps ``(batch, T, feature_dim)`` to
    ``(batch, T, channels[-1])``.  Parameters ``tdnn{i}.w`` ``(W, I, O)``
    and ``tdnn{i}.b``.

    Parameters
    ----------
    feature_dim
        Input feature dimension.
    channels
        Output channels per layer.
    kernel_widths
        Temporal kernel width per layer (1 = a frame-wise dense layer).
    dilations
        Temporal dilation per layer (defaults to 1 everywhere).
    dtype, device, generator
        As :class:`~speech_tpu_torch.models.kws.ConvClassifier`.
    """

    def __init__(
        self,
        feature_dim: int,
        channels: Sequence[int] = (128, 128, 128),
        kernel_widths: Sequence[int] = (5, 3, 1),
        dilations: Optional[Sequence[int]] = None,
        dtype=torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.feature_dim = int(feature_dim)
        self.channels = tuple(int(c) for c in channels)
        self.kernel_widths = tuple(int(k) for k in kernel_widths)
        if dilations is None:
            dilations = (1,) * len(self.channels)
        self.dilations = tuple(int(d) for d in dilations)
        if not len(self.channels) == len(self.kernel_widths) == len(self.dilations):
            raise ValueError(
                "channels, kernel_widths and dilations must have equal "
                f"lengths, got {len(self.channels)}, "
                f"{len(self.kernel_widths)}, {len(self.dilations)}"
            )
        if any(k < 1 for k in self.kernel_widths):
            raise ValueError(f"kernel widths must be >= 1: {self.kernel_widths}")
        if any(d < 1 for d in self.dilations):
            raise ValueError(f"dilations must be >= 1: {self.dilations}")
        self.dtype = _dtype(dtype)
        device = resolve_device(device)
        generator = _generator(generator)
        fan_in_dim = self.feature_dim
        for i, (out_c, k) in enumerate(zip(self.channels, self.kernel_widths)):
            self.add_module(f"tdnn{i}",
                            he_conv_init(generator, k, fan_in_dim, out_c, self.dtype, device))
            fan_in_dim = out_c

    def forward(self, feats, num_frames=None):
        """Frame-level activations, padded rows zeroed at every layer."""
        x = _as_input(feats, self.dtype, self.tdnn0.w.device)
        if x.dim() != 3:
            raise ValueError(f"feats must be (batch, T, F), got {tuple(x.shape)}")
        total = x.shape[1]
        num_frames = _as_counts(num_frames, x.shape[0], total, x.device)
        x = torch.where(valid_mask(total, num_frames)[..., None], x, 0)
        for i, d in enumerate(self.dilations):
            x, num_frames = masked_conv_block(x, getattr(self, f"tdnn{i}"), num_frames,
                                              dilation=d)
        return x


def _stats_pool(hidden, num_frames, eps):
    """Masked mean + std over the frame axis -> ``(batch, 2*C)``."""
    denom = torch.clamp_min(num_frames, 1).to(hidden.dtype)[:, None]
    mean = torch.sum(hidden, dim=1) / denom
    # rows past the count are zero, so subtract the mean only on valid rows
    mask = valid_mask(hidden.shape[1], num_frames)[..., None]
    centered = torch.where(mask, hidden - mean[:, None, :], 0)
    var = torch.sum(centered * centered, dim=1) / denom
    std = torch.sqrt(var + eps)
    return torch.cat([mean, std], dim=-1)


class SpeakerModel(_FrontendModel):
    """A frontend + :class:`TDNNEncoder` + stats pooling + linear embedding.

    ``frontend`` is any :mod:`speech_tpu_torch.nn` module with the
    ``frontend(signals, lengths)`` / ``frame_counts(lengths)`` contract::

        model = SpeakerModel(frontend, num_speakers=1000, embed_dim=192)
        emb = model.embed(signals, lengths)          # (B, 192); also model(...)
        loss, aux = model.loss(signals, lengths, labels)

    Parameters under the JAX ``params`` keys: ``frontend``, ``encoder``,
    ``embed`` (``w``, ``b``) and ``head`` (``w``, the AAM class weights,
    used only by :meth:`loss`).  The ``embed`` subtree shares its name with
    the :meth:`embed` method, as in the JAX package; reach it as
    ``model.embedding``.  ``train_frontend=False`` freezes the
    frontend.
    """

    def __init__(
        self,
        frontend,
        num_speakers: int,
        embed_dim: int = 192,
        channels: Sequence[int] = (128, 128, 128),
        kernel_widths: Sequence[int] = (5, 3, 1),
        dilations: Optional[Sequence[int]] = None,
        margin: float = 0.2,
        scale: float = 30.0,
        train_frontend: bool = True,
        eps: float = 1e-6,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if num_speakers < 2:
            raise ValueError(f"num_speakers must be >= 2, got {num_speakers}")
        if embed_dim < 1:
            raise ValueError(f"embed_dim must be >= 1, got {embed_dim}")
        if not 0.0 <= margin < math.pi / 2:
            raise ValueError(f"margin must be in [0, pi/2), got {margin}")
        if scale <= 0.0:
            raise ValueError(f"scale must be positive, got {scale}")
        self._init_frontend(frontend, train_frontend, dtype)
        self.num_speakers = int(num_speakers)
        self.embed_dim = int(embed_dim)
        self.margin = float(margin)
        self.scale = float(scale)
        self.eps = float(eps)
        generator = _generator(generator)
        self.encoder = TDNNEncoder(
            _frontend_dim(frontend),
            channels=channels,
            kernel_widths=kernel_widths,
            dilations=dilations,
            dtype=self.dtype,
            device=self.device,
            generator=generator,
        )
        pooled_dim = 2 * self.encoder.channels[-1]
        dt, dev = self.dtype, self.device
        emb_w = _normal(generator, (pooled_dim, self.embed_dim), dt, dev,
                        math.sqrt(1.0 / pooled_dim))
        head_w = _normal(generator, (self.embed_dim, self.num_speakers), dt, dev,
                         math.sqrt(1.0 / self.embed_dim))
        # set in _modules directly: `embed` is also the method's name
        self._modules["embed"] = ParamTree(
            {"w": emb_w, "b": torch.zeros(self.embed_dim, dtype=dt, device=dev)}
        )
        self.head = ParamTree({"w": head_w})

    @property
    def embedding(self) -> ParamTree:
        """The ``embed`` parameters (``w``, ``b``)."""
        return self._modules["embed"]

    def _embedding(self, hidden, counts):
        pooled = _stats_pool(hidden, counts, self.eps)
        with ieee_float32():
            return pooled @ self.embedding.w + self.embedding.b

    def embed(self, signals, lengths=None):
        """Speaker embeddings ``(batch, embed_dim)`` (not length-normalized)."""
        feats, counts = self._features(signals, lengths)
        return self._embedding(self.encoder(feats, counts), counts)

    def forward(self, signals, lengths=None):
        return self.embed(signals, lengths)

    def loss(self, signals, lengths, labels):
        """Mean AAM-softmax loss plus accuracy, as ``(loss, aux)``.

        The accuracy is computed on the *unpenalized* cosine logits — the
        margin-penalized logits depress the target column, so their argmax
        underreports true classification accuracy.
        """
        embeddings = self.embed(signals, lengths)
        labels = _as_counts(labels, embeddings.shape[0], 0, embeddings.device)
        loss, _ = aam_softmax_loss(
            embeddings, self.head.w, labels,
            margin=self.margin, scale=self.scale, eps=self.eps,
        )
        cos = _normalized_cos(embeddings, self.head.w, self.eps)
        acc = (torch.argmax(cos, dim=-1) == labels).to(cos.dtype).mean()
        return loss, {"accuracy": acc, "embeddings": embeddings}


class StreamingSpeaker(SlidingWindowStream):
    """Online speaker embedding over a sliding window of recent frames.

    The trained STFT frontend is exported to a computer and streamed chunk
    by chunk; every tick re-embeds the last ``window_frames`` frames
    through a snapshot of the TDNN + stats pooling + embedding stack.  Once
    ``window_frames`` covers the whole utterance the finalize-tick
    embedding equals :meth:`SpeakerModel.embed` on the full signal to
    roundoff.  See
    :class:`~speech_tpu_torch.models._common.SlidingWindowStream` for the
    tick and the :class:`~speech_tpu_torch.serve.StreamPool` contract.

    Example::

        ss = StreamingSpeaker(model, window_frames=300, chunk_size=1600)
        state = ss.init_state()
        for chunk in chunks:
            state, emb = ss.process(state, chunk)    # rolling embedding
        emb = ss.finalize(state)
    """

    def __init__(self, model: SpeakerModel, *, window_frames: int, chunk_size: int):
        if not hasattr(model.frontend, "export_computer"):
            raise ValueError(
                "StreamingSpeaker needs a frontend with export_computer "
                "(an STFTFrontend); "
                f"{type(model.frontend).__name__} has no streaming export"
            )
        self.model = model
        self._encoder = _snapshot(model.encoder)
        self._embed = _snapshot(model.embedding)
        super().__init__(
            model.frontend.export_computer(),
            window_frames=window_frames,
            chunk_size=chunk_size,
            dtype=model.dtype,
        )
        if self.num_coeffs != model.encoder.feature_dim:
            raise ValueError(
                f"encoder expects {model.encoder.feature_dim} "
                f"coefficients, computer produces {self.num_coeffs}"
            )

    def _score(self, window, v):
        pooled = _stats_pool(self._encoder(window, v), v, self.model.eps)
        with ieee_float32():
            return pooled @ self._embed.w + self._embed.b


def _normalized_cos(embeddings, class_weights, eps: float):
    """Cosine logits between L2-normalized embeddings and class columns."""
    emb_n = embeddings / torch.clamp_min(
        torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True), eps)
    w_n = class_weights / torch.clamp_min(
        torch.linalg.vector_norm(class_weights, dim=0, keepdim=True), eps)
    with ieee_float32():
        return emb_n @ w_n  # (B, num_speakers)


def aam_softmax_loss(
    embeddings,
    class_weights,
    labels,
    margin: float = 0.2,
    scale: float = 30.0,
    eps: float = 1e-6,
):
    """Additive-angular-margin softmax (ArcFace) over L2-normalized vectors.

    The target class's cosine similarity is replaced by ``cos(theta + m)``
    wherever that stays monotone (``theta + m < pi``, the standard ArcFace
    guard: past it the penalized logit falls back to ``cos - m*sin(m)``,
    which is continuous and still strictly below ``cos``); all logits are
    then scaled by ``s`` and fed to softmax cross-entropy.

    Returns ``(mean_loss, penalized_logits)``.
    """
    embeddings = torch.as_tensor(embeddings)
    class_weights = torch.as_tensor(class_weights)
    cos = _normalized_cos(embeddings, class_weights, eps)
    labels = _as_counts(labels, cos.shape[0], 0, cos.device)
    one_hot = F.one_hot(labels, cos.shape[-1]) > 0
    # the 1e-12 floor keeps the sqrt's gradient finite when a cosine rounds
    # to exactly +/-1 (an embedding converged onto its class weight):
    # sqrt-at-0 has an infinite derivative that the where branches
    # downstream cannot mask (0 * inf = NaN in the backward pass), and one
    # such example would NaN the whole batch gradient
    sin = torch.sqrt(torch.clamp_min(1.0 - cos * cos, 1e-12))
    cos_m = math.cos(margin)
    sin_m = math.sin(margin)
    phi = cos * cos_m - sin * sin_m  # cos(theta + m)
    # monotonicity guard: theta + m <= pi  <=>  cos(theta) >= cos(pi - m)
    phi = torch.where(cos > -cos_m, phi, cos - margin * sin_m)
    logits = scale * torch.where(one_hot, phi, cos)
    log_p = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_p, 1, labels[:, None])[:, 0]
    return nll.mean(), logits


def cosine_scores(emb_a, emb_b, eps: float = 1e-6):
    """Pairwise cosine scores ``(A, B)`` between two embedding batches."""
    emb_a = torch.as_tensor(emb_a)
    emb_b = torch.as_tensor(emb_b)
    a_n = emb_a / torch.clamp_min(torch.linalg.vector_norm(emb_a, dim=-1, keepdim=True), eps)
    b_n = emb_b / torch.clamp_min(torch.linalg.vector_norm(emb_b, dim=-1, keepdim=True), eps)
    with ieee_float32():
        return a_n @ b_n.T
