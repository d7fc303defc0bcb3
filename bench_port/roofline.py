"""The least time a configuration's feature work needs on one H100.

The work is counted from the configuration and the valid frames of the
inputs, never from the program: what these inputs need, not the padded
rows a kernel happens to compute.  The arithmetic is that of the kernel
table's bounds in ``PERF.md``: each unit's operations at its published
dense rate, and each byte read or written once at the memory's rate; the
larger of the two is the bound.

Routes and tiers (``"route"`` and ``"tier"`` of a configuration file):

- ``B2`` (the int8 digit kernel) at ``double`` / ``accurate``: every frame's
  DFT as ``pairs`` int8 digit products over ``dft // 2`` complex bins (a
  cos and a sin lane each), then the fp32 filter sums over each filter's
  span of nonzero bins, twice (the weights' hi and lo parts), and a rank-1
  Nyquist term per filter.
- ``B1`` (the TF32 float kernel) at ``highest`` / ``high`` (3 passes) or
  ``default`` (1 pass): the DFT on the TF32 tensor cores over ``dft // 2``
  bins, then the fp32 filter sums over each span, and the Nyquist row.

The number of digit pairs and of passes is a constant of the tier here: a
later implementation of a tier is read against the same work.
"""

# published H100 SXM peaks, dense (NVIDIA data sheet), at a 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# int8 digit pairs (i, j) a tier of B2 keeps.  B2 cuts every frame (x) and
# the DFT matrices (M) into 5 digits of base 128 with a margin bit each
# (|digit| <= 64), so x and M are held to 0.5 * 128^-5 = 2^-36 of their
# scales; pair (i, j) weighs 128^-(i+j+2), and a level s = i + j of n_s
# pairs adds at most n_s * 64^2 * 128^-(s+2) of the scales' product to a
# product.  A tier keeps each level down to the operands' own 2^-36:
# 'double' keeps s <= 5 (level 5: 4 * 2^12 * 2^-49 = 2^-35; the first
# level dropped, s = 6: 3 * 2^12 * 2^-56 < 2^-42, under it), which is
# 1 + 2 + 3 + 4 + 5 + 4 = 19 pairs; 'accurate' stops one level short,
# s <= 4, 15 pairs (the JAX kernel's _I8_X_DIGITS, _I8_M_DIGITS, _I8_CUTOFF
# and _I8_ACC_CUTOFF in speech_tpu/ops/stft.py).  The 13 and 10 pairs of
# the base-256 bf16 kernel (B4) are another kernel's.
DIGIT_PAIRS = {"double": 19, "accurate": 15}
# TF32 passes of the float kernel's DFT: hi*hi, hi*lo, lo*hi, or one
FLOAT_PASSES = {"highest": 3, "high": 3, "default": 1}

__all__ = ["PEAK_BYTES", "bound_s", "feature_work"]


def feature_work(spec, route: str, tier: str, frames: int, samples: int, launches: int = 1):
    """``(ops, nbytes)`` of the feature work of ``frames`` valid frames
    cut from ``samples`` valid float32 samples, in ``launches`` launches:
    ``ops`` a list of ``(operations, peak rate)``, ``nbytes`` the bytes
    read and written once (each launch reads its tables once).

    ``spec`` is a :class:`bench_port.reference.fbank.FbankSpec`."""
    K, F = spec.frame_length, spec.num_filts
    nb = spec.dft_size // 2
    spans = spec.filter_spans()
    rows = int((spans[:, 1] - spans[:, 0]).clip(min=0).sum())
    out_bytes = frames * spec.num_coeffs * 4
    in_bytes = samples * 4
    if route == "B2":
        pairs = DIGIT_PAIRS[tier]
        ops = [(2 * frames * K * 2 * nb * pairs, PEAK_INT8_OPS),
               (2 * frames * (2 * rows + F), PEAK_FP32_FLOPS)]
        # digit planes (int8), scales and mask, w_hi, w_lo, w_nyq
        tables = pairs * K * 2 * nb + 2 * nb * 4 + 3 * nb * F * 4
    elif route == "B1":
        ops = [(FLOAT_PASSES[tier] * 2 * frames * K * 2 * nb, PEAK_TF32_FLOPS),
               (2 * frames * (rows + F), PEAK_FP32_FLOPS)]
        # window-folded cos and sin, the weights
        tables = 2 * K * (nb + 1) * 4 + (nb + 1) * F * 4
    else:
        raise ValueError(f"no work count for route {route!r}")
    return ops, in_bytes + out_bytes + launches * tables


def bound_s(ops, nbytes):
    """The least seconds for the work: the larger of its operations over
    their peaks and its bytes over the memory's rate; and which."""
    t_ops = sum(n / peak for n, peak in ops)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
