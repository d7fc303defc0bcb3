"""Tensor forms of the post-processors, for on-device pipelines.

The PyTorch counterpart of :mod:`speech_tpu.ops.postops`.  The host classes
in :mod:`speech_tpu_torch.post` mirror the reference's NumPy API
(reference: src/pydrobert/speech/post.py); these are their tensor twins,
written to run on a batch on the card.  All take and return ``(..., time,
feats)`` tensors unless noted.  Shapes are static and nothing gathers per
element: shifted slices, prefix sums and one-hot contractions.  The
``lengths=`` forms take per-row valid frame counts and treat each row as
the unbatched op treats that row's prefix.
"""

from typing import Sequence

import numpy as np
import torch

from .stft import ieee_float32

__all__ = [
    "dct",
    "dct_matrix",
    "delta_filters",
    "device_post_chain",
    "pcen",
    "sliding_cmvn",
    "splice",
    "deltas",
    "stack",
    "standardize",
    "standardize_with_stats",
]


def delta_filters(num_deltas: int, context_window: int = 2):
    """The per-order Kaldi delta filters (order 1..num_deltas), host-side.

    Order-1 filter is ``t / sum t^2`` over ``[-W, W]``; higher orders are
    repeated convolutions (reference: post.py:455-460).
    """
    filts = [np.ones(1, dtype=np.float64)]
    base = np.arange(1 + 2 * context_window, dtype=np.float64) - context_window
    base /= np.sum(base ** 2)
    for idx in range(num_deltas):
        filts.append(np.convolve(filts[idx], base))
    return filts[1:]


def _edge_pad(x, axis: int, before: int, after: int):
    """Pad ``axis`` by replicating its first/last entry (numpy's 'edge')."""
    if not (before or after):
        return x
    head = x.narrow(axis, 0, 1).repeat_interleave(before, dim=axis)
    tail = x.narrow(axis, x.shape[axis] - 1, 1).repeat_interleave(after, dim=axis)
    return torch.cat([head, x, tail], dim=axis)


def _zero_pad(x, axis: int, after: int):
    shape = list(x.shape)
    shape[axis] = after
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _counts(lengths, device):
    """Per-row valid counts as an int64 tensor with a trailing axis."""
    return torch.as_tensor(lengths, device=device).to(torch.int64)[..., None]


def _scrub_and_last(features, lengths):
    """``(scrubbed, x_last (..., 1, F))`` for per-row valid counts over
    ``(..., T, F)`` features: rows at/after the count zero out, and the
    last valid frame extracts by a one-hot contraction."""
    T = features.shape[-2]
    cnt = _counts(lengths, features.device)  # (..., 1)
    pos = torch.arange(T, device=features.device)
    valid = pos < cnt  # (..., T)
    scrubbed = torch.where(valid[..., None], features, features.new_zeros(()))
    onehot = (pos == cnt - 1).to(features.dtype)
    x_last = torch.einsum("...tf,...t->...f", scrubbed, onehot)[..., None, :]
    return scrubbed, x_last


def deltas(
    features,
    filts: Sequence,
    concatenate: bool = True,
    time_axis: int = -2,
    target_axis: int = -1,
    lengths=None,
):
    """Append/stack delta orders of ``features``.

    ``filts`` from :func:`delta_filters`.  Edge (replication) padding,
    matching the reference default (reference: post.py:471-487).

    ``lengths`` (optional, ``(...,)`` per-row valid frame counts for
    ``(..., T, F)`` input, requires ``time_axis == -2``) replicates each
    row's edge at ITS valid extent: the zero-scrubbed correlation plus a
    rank-1 correction ``S(count - t) * x_last``, where ``S(m)`` sums the
    filter taps that overhang the row's end.
    """
    features = torch.as_tensor(features)
    time_axis = time_axis % features.ndim
    T = features.shape[time_axis]
    if lengths is not None:
        if time_axis != features.ndim - 2:
            raise ValueError("lengths-aware deltas requires time_axis=-2")
        features, x_last = _scrub_and_last(features, lengths)
        m = _counts(lengths, features.device) - torch.arange(T, device=features.device)
    outs = [features]
    for filt in filts:
        filt = np.asarray(filt)
        coef = torch.tensor(filt, dtype=features.dtype, device=features.device)
        off = (filt.shape[0] - 1) // 2
        if lengths is None:
            padded = _edge_pad(features, time_axis, off, off)
        else:
            # the left edge replicates frame 0; the ragged right edge is
            # zero-padded and corrected below
            padded = _zero_pad(_edge_pad(features, time_axis, off, 0), time_axis, off)
        acc = None
        for k in range(filt.shape[0]):
            term = padded.narrow(time_axis, k, T) * coef[k]
            acc = term if acc is None else acc + term
        if lengths is not None:
            # taps k with t - off + k >= count read the replicated last
            # frame: for overhang depth j = count - t in [1, off] their
            # coefficient sum is S(j) = sum_{k >= j + off} filt[k]
            corr = features.new_zeros(features.shape[:-1])
            for j in range(1, off + 1):
                s_j = float(filt[j + off :].sum())
                if s_j:
                    corr = corr + torch.where(
                        m == j,
                        torch.tensor(s_j, dtype=features.dtype, device=features.device),
                        features.new_zeros(()),
                    )
            acc = acc + corr[..., None] * x_last
        outs.append(acc)
    if concatenate:
        return torch.cat(outs, dim=target_axis)
    return torch.stack(outs, dim=target_axis)


def stack(
    features,
    num_vectors: int,
    time_axis: int = -2,
    feat_axis: int = -1,
    pad: bool = False,
    lengths=None,
):
    """Merge ``num_vectors`` consecutive frames into wider vectors.

    With ``pad``, the tail is edge-padded to divisibility; otherwise
    leftover frames are dropped (reference: post.py:536-554).

    ``lengths`` (per-row valid frame counts, requires the default axes)
    drops/edge-pads each row's tail at ITS valid extent.  Output row
    counts become ``lengths // num_vectors`` (``pad=False``) or the
    ceiling (``pad=True``); rows past a row's count are garbage to mask.
    """
    features = torch.as_tensor(features)
    time_axis = time_axis % features.ndim
    feat_axis = feat_axis % features.ndim
    if time_axis == feat_axis:
        raise RuntimeError(f"feature and time axes are the same ({time_axis})")
    T = features.shape[time_axis]
    if lengths is not None:
        if time_axis != features.ndim - 2 or feat_axis != features.ndim - 1:
            raise ValueError(
                "lengths-aware stack requires time_axis=-2, feat_axis=-1"
            )
        features, x_last = _scrub_and_last(features, lengths)
        if pad:
            # fill each row's final partial group with its last valid frame
            cnt = _counts(lengths, features.device)
            pos = torch.arange(T, device=features.device)
            grp_end = -(-cnt // num_vectors) * num_vectors
            fill = ((pos >= cnt) & (pos < grp_end))[..., None]
            features = torch.where(fill, x_last.expand_as(features), features)
    rem = T % num_vectors
    if rem and pad:
        features = _edge_pad(features, time_axis, 0, num_vectors - rem)
        T += num_vectors - rem
    T = (T // num_vectors) * num_vectors
    sl = [slice(None)] * features.ndim
    buffs = []
    for i in range(num_vectors):
        sl[time_axis] = slice(i, T, num_vectors)
        buffs.append(features[tuple(sl)])
    return torch.cat(buffs, dim=feat_axis)


def _scales(varss, norm_var: bool, like):
    if not norm_var:
        return torch.ones_like(like)
    varss = torch.where(
        torch.isclose(varss, torch.zeros_like(varss)), torch.ones_like(varss), varss
    )
    return torch.rsqrt(varss)


def standardize(features, norm_var: bool = True, feat_axis: int = -1):
    """Local (per-tensor) standardization over all axes but ``feat_axis``.

    Zero-variance coefficients scale by 1 (reference: post.py:282-287).
    """
    features = torch.as_tensor(features)
    feat_axis = feat_axis % features.ndim
    other = tuple(i for i in range(features.ndim) if i != feat_axis)
    means = features.mean(dim=other, keepdim=True)
    varss = (features ** 2).mean(dim=other, keepdim=True) - means ** 2 if norm_var else None
    scales = _scales(varss, norm_var, means)
    return features * scales - means * scales


def standardize_with_stats(features, stats, norm_var: bool = True, feat_axis: int = -1):
    """Global standardization from ``(2, F+1)`` sufficient statistics
    (reference: post.py:258-276)."""
    features = torch.as_tensor(features)
    stats = torch.as_tensor(stats, dtype=features.dtype, device=features.device)
    feat_axis = feat_axis % features.ndim
    count = stats[0, -1]
    means = stats[0, :-1] / count
    varss = stats[1, :-1] / count - means ** 2 if norm_var else None
    scales = _scales(varss, norm_var, means)
    shape = [1] * features.ndim
    shape[feat_axis] = -1
    scales = scales.reshape(shape)
    means = means.reshape(shape)
    return features * scales - means * scales


def dct_matrix(num_feats: int, num_ceps: int = None, lifter: float = 0.0) -> np.ndarray:
    """Host-side ``(num_feats, num_ceps)`` orthonormal DCT-II matrix.

    ``y = x @ dct_matrix(F, K)`` equals ``scipy.fft.dct(x, type=2,
    norm="ortho")[..., :K]``.  With ``lifter`` Q > 0, Kaldi's cepstral
    liftering ``c_k *= 1 + (Q/2) sin(pi k / Q)`` is folded into the
    matrix columns.
    """
    if num_ceps is None:
        num_ceps = num_feats
    if not 1 <= num_ceps <= num_feats:
        raise ValueError(f"Expected num_ceps in [1, {num_feats}], got {num_ceps}")
    if lifter < 0:
        raise ValueError(f"Expected lifter >= 0, got {lifter}")
    n = np.arange(num_feats, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)
    mat = np.cos(np.pi * np.outer(n + 0.5, k) / num_feats)
    mat *= np.sqrt(2.0 / num_feats)
    mat[:, 0] /= np.sqrt(2.0)
    if lifter:
        mat *= 1.0 + 0.5 * lifter * np.sin(np.pi * k / lifter)
    return mat


def _feature_matmul(features, mat, feat_axis: int):
    """``features`` times a host matrix along ``feat_axis``, in IEEE
    float32/float64 (TF32 off)."""
    mat = torch.tensor(mat, dtype=features.dtype, device=features.device)
    moved = torch.movedim(features, feat_axis, -1)
    with ieee_float32():
        return torch.matmul(moved, mat)


def dct(features, num_ceps: int = None, lifter: float = 0.0, feat_axis: int = -1):
    """Type-II orthonormal DCT along the feature axis (MFCC cepstrum):
    keep the first ``num_ceps`` coefficients and (optionally) lifter with
    coefficient ``lifter`` (Kaldi's ``--cepstral-lifter``).  One ``(F,
    K)`` matmul against :func:`dct_matrix`."""
    features = torch.as_tensor(features)
    feat_axis = feat_axis % features.ndim
    mat = dct_matrix(features.shape[feat_axis], num_ceps, lifter)
    return torch.movedim(_feature_matmul(features, mat, feat_axis), -1, feat_axis)


def transform(features, matrix, feat_axis: int = -1):
    """Apply a linear or affine feature transform (Kaldi ``transform-feats``).

    ``matrix`` is ``(out_dim, in_dim)`` for ``y = M x`` or ``(out_dim,
    in_dim + 1)`` for an affine one whose last column is the bias.
    """
    features = torch.as_tensor(features)
    feat_axis = feat_axis % features.ndim
    matrix = np.asarray(matrix)
    if matrix.ndim != 2:
        raise ValueError(f"expected a 2-D transform, got shape {matrix.shape}")
    in_dim = features.shape[feat_axis]
    if matrix.shape[1] == in_dim:
        bias = None
    elif matrix.shape[1] == in_dim + 1:
        matrix, bias = matrix[:, :-1], matrix[:, -1]
    else:
        raise ValueError(
            f"transform of shape {matrix.shape} does not apply to "
            f"{in_dim}-dimensional features (expected {in_dim} columns, "
            f"or {in_dim + 1} for an affine transform)"
        )
    out = _feature_matmul(features, np.ascontiguousarray(matrix.T), feat_axis)
    if bias is not None:
        out = out + torch.tensor(bias, dtype=features.dtype, device=features.device)
    return torch.movedim(out, -1, feat_axis)


def _pcen_compress(features, m, alpha, delta, power, eps):
    """The PCEN gain/compression stage given the smoothed energies ``m``."""

    def param(v):
        return torch.as_tensor(np.asarray(v), dtype=features.dtype).to(features.device)

    alpha, delta, power = param(alpha), param(delta), param(power)
    gain = torch.exp(-alpha * torch.log(eps + m))
    return torch.exp(power * torch.log(features * gain + delta)) - torch.exp(
        power * torch.log(delta)
    )


def _linear_scan(a, b, axis: int):
    """Inclusive prefix scan of ``m_t = a_t m_{t-1} + b_t`` (from
    ``m_{-1} = 0``) along ``axis``, in log depth: Hillis-Steele doubling
    with the combine ``(a_l, b_l), (a_r, b_r) -> (a_l a_r, b_l a_r +
    b_r)``."""
    T = a.shape[axis]
    d = 1
    while d < T:
        a_prev = torch.cat([torch.ones_like(a.narrow(axis, 0, d)), a.narrow(axis, 0, T - d)], dim=axis)
        b_prev = torch.cat([torch.zeros_like(b.narrow(axis, 0, d)), b.narrow(axis, 0, T - d)], dim=axis)
        a, b = a_prev * a, b_prev * a + b
        d *= 2
    return b


def pcen(
    features,
    smooth=0.025,
    alpha=0.98,
    delta=2.0,
    power=0.5,
    eps: float = 1e-6,
    init_state=None,
    time_axis: int = -2,
    return_state: bool = False,
    lengths=None,
):
    """Per-channel energy normalization (PCEN, Wang et al. 2017).

    ``PCEN = (E / (eps + M)^alpha + delta)^power - delta^power`` where
    ``M`` is the first-order IIR smoother ``M_t = (1-s) M_{t-1} + s E_t``,
    computed as a log-depth prefix scan over the time axis.  Applies to
    *linear* (magnitude or power) features.

    ``smooth``/``alpha``/``delta``/``power`` may be scalars or per-channel
    arrays broadcastable against the feature (last) axis.  ``init_state``
    is the smoother carry ``M_{-1}`` (None starts at the first frame's
    energy).  With ``return_state`` the final smoother state is returned
    too, so chunks stream exactly.  ``lengths`` (per-row valid frame
    counts, requires ``time_axis == -2``) makes rows at/after a row's
    count scan identities.
    """
    features = torch.as_tensor(features)
    time_axis = time_axis % features.ndim
    smooth = torch.as_tensor(np.asarray(smooth), dtype=features.dtype).to(features.device)
    decay = 1.0 - smooth
    valid = None
    if lengths is not None:
        if time_axis != features.ndim - 2:
            raise ValueError("lengths-aware pcen requires time_axis=-2")
        T = features.shape[-2]
        pos = torch.arange(T, device=features.device)
        valid = (pos < _counts(lengths, features.device))[..., None]
        features = torch.where(valid, features, features.new_zeros(()))
    b = smooth * features
    # fold the initial state into the first element so the prefix scan
    # directly yields M_t; M_{-1} = E_0 by default (steady start)
    first = features.narrow(time_axis, 0, 1)
    if init_state is None:
        m0 = first
    else:
        m0 = torch.as_tensor(init_state, dtype=features.dtype).to(features.device)
        if m0.ndim == features.ndim - 1:  # the return_state convention
            m0 = m0.unsqueeze(time_axis)
    b0 = decay * m0.expand_as(first) + smooth * first
    b = torch.cat([b0, b.narrow(time_axis, 1, b.shape[time_axis] - 1)], dim=time_axis)
    a = decay.expand_as(features)
    if valid is not None:
        a = torch.where(valid, a, torch.ones_like(a))
        b = torch.where(valid, b, torch.zeros_like(b))
    m = _linear_scan(a, b, time_axis)
    out = _pcen_compress(features, m, alpha, delta, power, eps)
    if return_state:
        return out, m.select(time_axis, m.shape[time_axis] - 1)
    return out


def sliding_cmvn(
    features,
    window: int = 600,
    center: bool = True,
    norm_var: bool = False,
    min_window: int = 100,
    time_axis: int = -2,
    lengths=None,
):
    """Sliding-window cepstral mean (and variance) normalization.

    Kaldi ``apply-cmvn-sliding`` semantics: each frame normalizes by
    statistics over a ``window``-frame context, centered and edge-clipped
    when ``center``, else trailing with at least ``min_window`` frames.
    Windowed moments come from prefix-sum rows.  ``lengths`` (per-row
    valid frame counts, requires ``time_axis == -2``) clips each row's
    window at ITS valid extent; where a row's count binds, the statistics
    collapse to one per-row value, read by one-hot contractions.
    """
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")
    features = torch.as_tensor(features)
    time_axis = time_axis % features.ndim
    if time_axis != features.ndim - 2:
        if lengths is not None:
            raise ValueError("lengths-aware sliding_cmvn requires time_axis=-2")
        moved = torch.movedim(features, time_axis, -2)
        out = sliding_cmvn(moved, window, center, norm_var, min_window, -2)
        return torch.movedim(out, -2, time_axis)
    T = features.shape[-2]
    dev = features.device
    idx = np.arange(T)
    # unclamped (infinite-stream) bounds, static per frame index
    if center:
        lo_nat = np.maximum(idx - window // 2, 0)
        hi_nat = lo_nat + window
    else:
        hi_nat = np.maximum(idx + 1, min_window)
        lo_nat = np.maximum(hi_nat - window, 0)

    def prefix(x):
        c = torch.cumsum(x, dim=-2)
        return c, torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)

    if lengths is None:
        hi = torch.as_tensor(np.minimum(hi_nat, T), device=dev)
        lo = torch.as_tensor(np.maximum(np.minimum(hi_nat, T) - window, 0), device=dev)

        def moments(x):
            _, cp = prefix(x)
            return cp.index_select(-2, hi) - cp.index_select(-2, lo)

        count = (hi - lo).to(features.dtype)[:, None]
        mean = moments(features) / count
        out = features - mean
        if norm_var:
            var = moments(features ** 2) / count - mean ** 2
            out = out * torch.rsqrt(torch.clamp_min(var, 1e-10))
        return out

    cnt = _counts(lengths, dev)  # (..., 1)
    pos = torch.arange(T, device=dev)
    scrubbed = torch.where((pos < cnt)[..., None], features, features.new_zeros(()))
    # where hi_nat <= count the static bounds hold (interior); where the
    # count binds, hi = count and lo = max(count - window, 0): one window
    # per row, read by one-hot contractions against the prefix table
    interior = torch.as_tensor(hi_nat, device=dev) <= cnt  # (..., T)
    onehot_hi = (pos[:, None] + 1 == cnt[..., None, :]).to(features.dtype)
    lo_tail = torch.clamp_min(cnt - window, 0)  # (..., 1)
    onehot_lo = (pos[:, None] == lo_tail[..., None, :]).to(features.dtype)
    hi_idx = torch.as_tensor(np.minimum(hi_nat, T), device=dev)
    lo_idx = torch.as_tensor(np.minimum(lo_nat, T), device=dev)

    def moments(x):
        c, cp = prefix(x)
        static = cp.index_select(-2, hi_idx) - cp.index_select(-2, lo_idx)
        tail_hi = torch.einsum("...tf,...to->...of", c, onehot_hi)
        tail_lo = torch.einsum("...tf,...to->...of", cp[..., :-1, :], onehot_lo)
        return torch.where(interior[..., None], static, tail_hi - tail_lo)

    count = torch.minimum(hi_idx, cnt) - torch.where(interior, lo_idx, lo_tail)
    count = torch.clamp_min(count, 1).to(features.dtype)[..., None]
    mean = moments(scrubbed) / count
    out = features - mean
    if norm_var:
        var = moments(scrubbed ** 2) / count - mean ** 2
        out = out * torch.rsqrt(torch.clamp_min(var, 1e-10))
    return out


def splice(features, left: int = 4, right: int = 4, time_axis: int = -2, lengths=None):
    """Concatenate each frame with its ``[-left, right]`` context (Kaldi
    ``splice-feats``).  Edge frames replicate; output width is ``(left +
    right + 1) * F``, context oldest-first.  ``lengths`` makes the right
    edge ragged-aware: taps that overhang a row's valid extent select its
    last valid frame."""
    if left < 0 or right < 0:
        raise ValueError(f"left/right must be >= 0, got {left}/{right}")
    features = torch.as_tensor(features)
    time_axis = time_axis % features.ndim
    T = features.shape[time_axis]
    if lengths is None:
        padded = _edge_pad(features, time_axis, left, right)
        outs = [padded.narrow(time_axis, k, T) for k in range(left + right + 1)]
        return torch.cat(outs, dim=-1)
    if time_axis != features.ndim - 2:
        raise ValueError("lengths-aware splice requires time_axis=-2")
    features, x_last = _scrub_and_last(features, lengths)
    pos = torch.arange(T, device=features.device)
    cnt = _counts(lengths, features.device)
    padded = _zero_pad(_edge_pad(features, time_axis, left, 0), time_axis, right)
    outs = []
    for k in range(left + right + 1):
        sl = padded.narrow(time_axis, k, T)
        d = k - left  # tap offset relative to the output frame
        if d > 0:
            over = (pos + d >= cnt)[..., None]
            sl = torch.where(over, x_last.expand_as(sl), sl)
        outs.append(sl)
    return torch.cat(outs, dim=-1)


def device_post_chain(postprocessors):
    """A ragged-batch-aware device twin of a post-processor chain.

    Maps host :mod:`speech_tpu_torch.post` instances (and/or raw ``(feats,
    counts) -> (feats, counts)`` callables) onto this module's
    lengths-aware forms and returns one ``apply(feats, counts) -> (feats,
    counts)`` over ``(..., T, F)`` feature tensors with per-row valid frame
    counts.  Semantics are the device twins' (deltas/splice/stacking run
    along the TIME axis with per-row edge handling), matching
    per-utterance host application of each post-processor with its
    natural time axis.  Raises ``ValueError`` for configurations with no
    device twin (e.g. :class:`~speech_tpu_torch.post.Standardize` without
    statistics).
    """
    from .. import post as _post
    from .plp import plp as _plp

    stages = []
    for p in postprocessors:
        if callable(p) and not isinstance(p, _post.PostProcessor):
            stages.append(p)
            continue
        if isinstance(p, _post.Deltas):
            if not p.concatenate:
                raise ValueError("device Deltas supports the concatenating form only")
            if p._target_axis not in (-1, 1):
                raise ValueError("device Deltas requires target_axis -1 (feature axis)")
            if p._pad_mode != "edge":
                raise ValueError(
                    f"device Deltas requires pad_mode='edge', got {p._pad_mode!r}"
                )
            filts = [np.asarray(f) for f in p.filters[1:]]

            def f(x, n, filts=filts):
                return deltas(x, filts, lengths=n), n

        elif isinstance(p, _post.Splice):
            if p.time_axis % 2 != 0:
                raise ValueError("device Splice requires time_axis 0")
            left, right = p.left, p.right

            def f(x, n, left=left, right=right):
                return splice(x, left, right, lengths=n), n

        elif isinstance(p, _post.Stack):
            if p.time_axis % 2 != 0:
                raise ValueError("device Stack requires time_axis 0")
            if p._pad_mode not in (None, "edge"):
                raise ValueError(
                    f"device Stack supports pad_mode None or 'edge', got {p._pad_mode!r}"
                )
            m, do_pad = p.num_vectors, p._pad_mode == "edge"

            def f(x, n, m=m, do_pad=do_pad):
                out = stack(x, m, pad=do_pad, lengths=n)
                return out, (-(-n // m) if do_pad else n // m)

        elif isinstance(p, _post.PCEN):
            if p.time_axis % 2 != 0:
                raise ValueError("device PCEN requires time_axis 0")
            kw = dict(smooth=p.smooth, alpha=p.alpha, delta=p.delta, power=p.power, eps=p.eps)

            def f(x, n, kw=kw):
                return pcen(x, lengths=n, **kw), n

        elif isinstance(p, _post.SlidingCMVN):
            if p.time_axis % 2 != 0:
                raise ValueError("device SlidingCMVN requires time_axis 0")
            kw = dict(
                window=p.window, center=p.center, norm_var=p.norm_var,
                min_window=p.min_window,
            )

            def f(x, n, kw=kw):
                return sliding_cmvn(x, lengths=n, **kw), n

        elif isinstance(p, _post.DCT):
            num_ceps, lifter = p.num_ceps, p.lifter

            def f(x, n, num_ceps=num_ceps, lifter=lifter):
                return dct(x, num_ceps, lifter), n

        elif isinstance(p, _post.PLP):
            center_hz = p.center_hz
            kw = dict(
                order=p.order, num_ceps=p.num_ceps, compress=p.compress,
                lifter=p.lifter, eps=p.eps,
            )

            def f(x, n, center_hz=center_hz, kw=kw):
                return _plp(x, center_hz, **kw), n

        elif isinstance(p, _post.Transform):
            mat = np.asarray(p.matrix)

            def f(x, n, mat=mat):
                return transform(x, mat), n

        elif isinstance(p, _post.Standardize):
            if not p.have_stats:
                raise ValueError("device Standardize needs accumulated/loaded statistics")
            stats = np.asarray(p.stats)
            norm_var = p._norm_var

            def f(x, n, stats=stats, norm_var=norm_var):
                return standardize_with_stats(x, stats, norm_var), n

        else:
            raise ValueError(f"no device twin for {type(p).__name__}")
        stages.append(f)

    def apply(feats, counts):
        counts = torch.as_tensor(counts, device=feats.device).to(torch.int64)
        for stage in stages:
            feats, counts = stage(feats, counts)
        return feats, counts

    return apply
