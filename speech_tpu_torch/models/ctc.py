"""CTC acoustic-model family: frontend -> conv subsample -> transformer -> CTC.

The counterpart of :mod:`speech_tpu.models.ctc`, as
:class:`torch.nn.Module` s: any :mod:`speech_tpu_torch.nn` frontend,
strided conv subsampling, a stack of pre-LN transformer encoder blocks,
and a CTC head (blank id 0).  Parameters carry the JAX ``params`` keys as
their dotted names, in its layouts (``wq``/``wk``/``wv`` ``(d, h, k)``,
``wo`` ``(h, k, d)``).

- The attention and FFN are the JAX package's einsums as torch ops
  (cuBLAS, IEEE float32); padded *keys* get an additive bias of ``-1e9``
  (``-1e300`` in float64), and padded rows are re-zeroed, so logits on
  valid frames do not depend on how far the batch was padded.
- The loss is ``optax.ctc_loss``'s forward recursion over frames on the
  ``(batch, labels + 1)`` lattice, ported op for op with its
  ``log_epsilon`` of ``-1e5`` standing in for log(0): a row with more
  labels than its frames can align (an infeasible row) gets optax's large
  finite loss, where ``torch.nn.functional.ctc_loss`` gives ``inf``.  Its
  gradient is autograd's through the recursion, deterministic on the
  card.
"""

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ._common import (
    ParamTree,
    _FrontendModel,
    _as_counts,
    _as_input,
    _dtype,
    _frontend_dim,
    _generator,
    _host,
    _normal,
    he_conv_init,
    load_params,
    make_train_step,
    masked_conv_block,
    params_from_jax,
    save_params,
    valid_mask,
)
from ..ops._device import host_constant, resolve_device
from ..ops.stft import ieee_float32

__all__ = [
    "TransformerEncoder",
    "CTCModel",
    "ctc_loss",
    "greedy_decode",
    "beam_search_decode",
    "make_train_step",
    "params_from_jax",
    "save_params",
    "load_params",
]


def _norm(params, x, eps=1e-6):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return params["g"] * (x - mean) * torch.rsqrt(var + eps) + params["b"]


def _sinusoid_posenc(max_len: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal positions (Vaswani et al. 2017), on the host in
    float64."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    half = (dim + 1) // 2
    inv = np.exp(-math.log(10000.0) * np.arange(half) / max(half - 1, 1))
    ang = pos * inv[None, :]
    enc = np.zeros((max_len, dim))
    enc[:, 0::2] = np.sin(ang)[:, : enc[:, 0::2].shape[1]]
    enc[:, 1::2] = np.cos(ang)[:, : enc[:, 1::2].shape[1]]
    return enc


class TransformerEncoder(torch.nn.Module):
    """Pre-LN transformer encoder stack with key-side padding masks.

    ``hidden = enc(x, num_frames)`` maps ``(batch, T, model_dim)`` to the
    same shape, with rows at or past the valid count zeroed on output.
    Parameters ``layer{i}.{ln1,ln2}.{g,b}``, ``layer{i}.{wq,wk,wv}``
    ``(d, h, k)``, ``layer{i}.wo`` ``(h, k, d)``,
    ``layer{i}.{ffn1,ffn2}.{w,b}`` and ``ln_out.{g,b}``.
    """

    def __init__(
        self,
        model_dim: int,
        num_layers: int = 2,
        num_heads: int = 4,
        ffn_dim: Optional[int] = None,
        max_len: int = 4096,
        dtype=torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if model_dim % num_heads:
            raise ValueError(
                f"model_dim ({model_dim}) must divide by num_heads ({num_heads})"
            )
        if num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {num_layers}")
        self.model_dim = int(model_dim)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = self.model_dim // self.num_heads
        self.ffn_dim = int(ffn_dim) if ffn_dim is not None else 4 * model_dim
        self.max_len = int(max_len)
        self.dtype = _dtype(dtype)
        dev = resolve_device(device)
        gen = _generator(generator)
        d, h, hd, f, dt = self.model_dim, self.num_heads, self.head_dim, self.ffn_dim, self.dtype
        scale_d, scale_f = math.sqrt(1.0 / d), math.sqrt(1.0 / f)

        def norm():
            return {"g": torch.ones(d, dtype=dt, device=dev),
                    "b": torch.zeros(d, dtype=dt, device=dev)}

        for i in range(self.num_layers):
            self.add_module(f"layer{i}", ParamTree({
                "ln1": norm(),
                "ln2": norm(),
                "wq": _normal(gen, (d, h, hd), dt, dev, scale_d),
                "wk": _normal(gen, (d, h, hd), dt, dev, scale_d),
                "wv": _normal(gen, (d, h, hd), dt, dev, scale_d),
                "wo": _normal(gen, (h, hd, d), dt, dev, scale_d),
                "ffn1": {"w": _normal(gen, (d, f), dt, dev, scale_d),
                         "b": torch.zeros(f, dtype=dt, device=dev)},
                "ffn2": {"w": _normal(gen, (f, d), dt, dev, scale_f),
                         "b": torch.zeros(d, dtype=dt, device=dev)},
            }))
        self.ln_out = ParamTree(norm())

    def forward(self, x, num_frames=None):
        x = _as_input(x, self.dtype, self.ln_out.g.device)
        if x.dim() != 3 or x.shape[-1] != self.model_dim:
            raise ValueError(f"x must be (batch, T, {self.model_dim}), got {tuple(x.shape)}")
        total = x.shape[1]
        if total > self.max_len:
            raise ValueError(f"sequence length {total} exceeds max_len {self.max_len}")
        num_frames = _as_counts(num_frames, x.shape[0], total, x.device)
        frame_ok = valid_mask(total, num_frames)
        x = torch.where(frame_ok[..., None], x, 0)
        x = x + host_constant(_sinusoid_posenc(total, self.model_dim), x.dtype, x.device)[None]
        # additive key-side bias: padded keys never receive attention mass
        neg = -1e300 if self.dtype == torch.float64 else -1e9
        key_bias = torch.zeros(frame_ok.shape, dtype=x.dtype, device=x.device)
        key_bias = key_bias.masked_fill(~frame_ok, neg)[:, None, None, :]
        inv_sqrt = 1.0 / math.sqrt(self.head_dim)
        with ieee_float32():
            for i in range(self.num_layers):
                lyr = getattr(self, f"layer{i}")
                h = _norm(lyr.ln1, x)
                q = torch.einsum("btd,dhk->bhtk", h, lyr.wq)
                k = torch.einsum("btd,dhk->bhtk", h, lyr.wk)
                v = torch.einsum("btd,dhk->bhtk", h, lyr.wv)
                scores = torch.einsum("bhtk,bhsk->bhts", q, k) * inv_sqrt
                attn = torch.softmax(scores + key_bias, dim=-1)
                ctx = torch.einsum("bhts,bhsk->bhtk", attn, v)
                x = x + torch.einsum("bhtk,hkd->btd", ctx, lyr.wo)
                h = _norm(lyr.ln2, x)
                h = torch.relu(h @ lyr.ffn1.w + lyr.ffn1.b)
                x = x + (h @ lyr.ffn2.w + lyr.ffn2.b)
        x = _norm(self.ln_out, x)
        return torch.where(frame_ok[..., None], x, 0)


def ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id: int = 0,
             log_epsilon: float = -1e5):
    """Per-sequence CTC loss, ``optax.ctc_loss`` op for op.

    ``logits`` ``(B, T, K)`` (normalized by a ``log_softmax`` here, as
    optax does), ``logit_paddings`` ``(B, T)`` and ``label_paddings``
    ``(B, N)`` of 1.0 at padded positions, ``labels`` ``(B, N)``
    right-padded.  The forward recursion runs over the ``T`` frames (a
    Python loop of a dozen ops a frame); ``log_epsilon`` stands in for
    log(0), so an infeasible row's loss is large and finite (about
    ``-log_epsilon`` per missing transition) rather than ``inf``.
    Returns ``(B,)``.
    """
    B, T, _ = logits.shape
    N = labels.shape[1]
    dt, dev = logits.dtype, logits.device
    logprobs = F.log_softmax(logits, dim=-1)
    labels = labels.to(torch.int64)
    labellens = N - torch.sum(label_paddings, dim=1).to(torch.int64)
    # repeat[b, n] == 1.0 when label[b, n] == label[b, n+1]
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dt), (0, 1))
    logprobs_phi = logprobs[:, :, blank_id : blank_id + 1].transpose(0, 1)  # (T, B, 1)
    logprobs_emit = torch.gather(
        logprobs, 2, labels[:, None, :].expand(B, T, N)).transpose(0, 1)  # (T, B, N)
    pads = logit_paddings.to(dt).transpose(0, 1)  # (T, B)

    phi = torch.full((B, N + 1), log_epsilon, dtype=dt, device=dev)
    phi = torch.cat([torch.zeros((B, 1), dtype=dt, device=dev), phi[:, 1:]], dim=1)
    emit = torch.full((B, N), log_epsilon, dtype=dt, device=dev)

    def update_phi_score(phi, added):
        # phi[:, 1:] gains `added` in log space
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    for t in range(T):
        prev_phi_orig = phi
        # emit-to-phi epsilon transition, except if the next label repeats
        prev_phi = update_phi_score(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi, pad = logprobs_emit[t], logprobs_phi[t], pads[t][:, None]
        # phi-to-emit transition
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        # self-loop transition
        next_phi = prev_phi + lp_phi
        # emit-to-phi blank transition only when the next label repeats
        next_phi = update_phi_score(next_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi

    # the last row gets the last epsilon transition
    phi_last = update_phi_score(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]


class CTCModel(_FrontendModel):
    """Frontend + conv subsampling + :class:`TransformerEncoder` + CTC head.

    ``vocab_size`` counts real symbols; the blank is id 0 and the head emits
    ``vocab_size + 1`` logits::

        model = CTCModel(frontend, vocab_size=28, model_dim=128)
        log_probs, counts = model(signals, lengths)
        loss, aux = model.loss(signals, lengths, labels, label_lengths)

    ``labels`` are ``(batch, max_label_len)`` integers with ids in ``[1,
    vocab_size]`` (0 is the blank, never a label).  Parameters under the
    JAX ``params`` keys: ``frontend``, ``subsample.conv{i}``, ``encoder``
    and ``head``.
    """

    def __init__(
        self,
        frontend,
        vocab_size: int,
        model_dim: int = 128,
        num_layers: int = 2,
        num_heads: int = 4,
        ffn_dim: Optional[int] = None,
        subsample_strides: Sequence[int] = (2, 2),
        subsample_width: int = 3,
        max_len: int = 4096,
        train_frontend: bool = True,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if vocab_size < 1:
            raise ValueError(f"vocab_size must be >= 1, got {vocab_size}")
        if any(s < 1 for s in subsample_strides):
            raise ValueError(f"subsample strides must be >= 1: {subsample_strides}")
        if subsample_width < 1:
            raise ValueError(f"subsample_width must be >= 1, got {subsample_width}")
        self._init_frontend(frontend, train_frontend, dtype)
        self.vocab_size = int(vocab_size)
        self.subsample_strides = tuple(int(s) for s in subsample_strides)
        self.subsample_width = int(subsample_width)
        gen = _generator(generator)
        dt, dev = self.dtype, self.device
        self.encoder = TransformerEncoder(
            model_dim, num_layers=num_layers, num_heads=num_heads, ffn_dim=ffn_dim,
            max_len=max_len, dtype=dt, device=dev, generator=gen,
        )
        d = self.encoder.model_dim
        self.subsample = torch.nn.Module()
        fan_in_dim = _frontend_dim(frontend)
        for i, _ in enumerate(self.subsample_strides):
            self.subsample.add_module(
                f"conv{i}", he_conv_init(gen, self.subsample_width, fan_in_dim, d, dt, dev))
            fan_in_dim = d
        # zero head: initial output is the uniform distribution
        self.head = ParamTree({
            "w": torch.zeros((d, self.vocab_size + 1), dtype=dt, device=dev),
            "b": torch.zeros(self.vocab_size + 1, dtype=dt, device=dev),
        })

    def out_frame_counts(self, lengths):
        """Valid encoder frame counts for signal sample ``lengths``."""
        counts = self.frontend.frame_counts(_as_counts(lengths, 0, 0, self.device))
        for s in self.subsample_strides:
            counts = -torch.div(-counts, s, rounding_mode="floor")
        return counts

    def forward(self, signals, lengths=None):
        """``(log_probs, counts)``: ``(B, T', vocab+1)`` and valid frames."""
        x, valid = self._features(signals, lengths)
        x = torch.where(valid_mask(x.shape[1], valid)[..., None], x, 0)
        for i, stride in enumerate(self.subsample_strides):
            x, valid = masked_conv_block(x, getattr(self.subsample, f"conv{i}"), valid,
                                         stride=stride)
        x = self.encoder(x, valid)
        with ieee_float32():
            logits = x @ self.head.w + self.head.b
        return F.log_softmax(logits, dim=-1), valid

    def loss(self, signals, lengths, labels, label_lengths):
        """Mean per-utterance CTC loss, as ``(loss, aux)``.

        ``aux`` carries the per-example losses, the frame-level
        ``log_probs`` and the valid frame ``counts`` (for decoding).
        """
        log_probs, counts = self(signals, lengths)
        dev = log_probs.device
        labels = _as_counts(labels, 0, 0, dev)
        label_lengths = _as_counts(label_lengths, 0, 0, dev)
        t_idx = torch.arange(log_probs.shape[1], device=dev)
        logit_pad = (t_idx[None, :] >= counts[:, None]).to(log_probs.dtype)
        u_idx = torch.arange(labels.shape[1], device=dev)
        label_pad = (u_idx[None, :] >= label_lengths[:, None]).to(log_probs.dtype)
        per_ex = ctc_loss(log_probs, logit_pad, labels, label_pad)
        return per_ex.mean(), {"per_example": per_ex, "log_probs": log_probs, "counts": counts}


def greedy_decode(log_probs, counts, blank_id: int = 0):
    """Best-path CTC decode: argmax, collapse repeats, strip blanks.

    Host-side helper (decoding is inherently ragged); returns a list of
    1-D int numpy arrays, one per batch row.
    """
    log_probs = _host(log_probs)
    counts = _host(counts)
    out = []
    best = log_probs.argmax(axis=-1)
    for row, count in zip(best, counts):
        row = row[: int(count)]
        keep = np.ones(len(row), dtype=bool)
        keep[1:] = row[1:] != row[:-1]
        row = row[keep]
        out.append(row[row != blank_id].astype(np.int64))
    return out


def _logsumexp2(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    hi, lo = (a, b) if a > b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


def beam_search_decode(log_probs, counts, beam_width: int = 8, blank_id: int = 0):
    """CTC prefix beam search (Hannun et al. 2014), host-side.

    Merges all alignments of each label prefix by tracking separate
    blank-ending and non-blank-ending probabilities, so a prefix reachable
    through many paths outranks a single-best path.  Exact for
    ``beam_width >= (num_labels + 1) ** T``.

    Returns a list of ``(labels, log_prob)`` tuples, one per batch row,
    where ``labels`` is a 1-D int numpy array and ``log_prob`` is the total
    (path-summed) log probability of that label sequence.
    """
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    log_probs = _host(log_probs).astype(np.float64)
    counts = _host(counts)
    out = []
    for row, count in zip(log_probs, counts):
        # beams: prefix tuple -> [log P(ends in blank), log P(ends in label)]
        beams = {(): [0.0, -math.inf]}
        for t in range(int(count)):
            frame = row[t]
            nxt: dict = {}
            for prefix, (p_b, p_nb) in beams.items():
                total = _logsumexp2(p_b, p_nb)
                # extend with blank: prefix unchanged, now blank-ending
                cell = nxt.setdefault(prefix, [-math.inf, -math.inf])
                cell[0] = _logsumexp2(cell[0], total + frame[blank_id])
                # repeat the last label WITHOUT a separating blank: prefix
                # unchanged, stays non-blank-ending
                if prefix:
                    last = prefix[-1]
                    cell[1] = _logsumexp2(cell[1], p_nb + frame[last])
                # extend with a new label
                for s in range(len(frame)):
                    if s == blank_id:
                        continue
                    ext = prefix + (s,)
                    cell = nxt.setdefault(ext, [-math.inf, -math.inf])
                    if prefix and s == prefix[-1]:
                        # same label again needs the blank separator: only
                        # blank-ending mass extends
                        cell[1] = _logsumexp2(cell[1], p_b + frame[s])
                    else:
                        cell[1] = _logsumexp2(cell[1], total + frame[s])
            beams = dict(
                sorted(nxt.items(), key=lambda kv: -_logsumexp2(*kv[1]))[:beam_width]
            )
        best = max(beams.items(), key=lambda kv: _logsumexp2(*kv[1]))
        out.append((np.asarray(best[0], dtype=np.int64), _logsumexp2(*best[1])))
    return out
