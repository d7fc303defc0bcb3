"""The least time Kaldi-style pitch tracking needs on one H100, from the
configuration's ``"pitch"`` block and the tracked frames of the inputs
(never from the program's padded rows), at the peaks of
:mod:`bench_port.roofline`:

- operations, at the float32 rate outside the tensor cores: the NCCF's
  products a tracked frame (every integer lag's inner product and window
  energy, ``window`` products each; the frame's own energy; the two
  NCCFs' interpolation onto the lag grid, ``int_lags * lags`` products
  each) and the Viterbi's min-plus step, an add and a min for each of the
  ``lags * lags`` pairs of lags;
- bytes: a tracked frame's local costs read (``lags`` float32) and its
  back-pointers written (``lags`` int16, the narrowest index that holds a
  lag), and the ``(lags, lags)`` float32 transition table read once a
  launch: every row and step shares it, and it fits in the L2 cache.

The costs carried from one step to the next stay on the chip, so a
step's work reads no ``(rows, lags, lags)`` block.
"""

from .roofline import PEAK_FP32_FLOPS

__all__ = ["pitch_work"]


def pitch_work(pspec, frames: int, launches: int = 1):
    """``(ops, nbytes)`` of ``frames`` tracked frames in ``launches``
    batches, as :func:`bench_port.roofline.bound_s` takes them; ``pspec``
    a :class:`bench_port.reference.pitch.PitchSpec`."""
    n_int, L, W = len(pspec.int_lags), len(pspec.lags), pspec.window
    macs = 2 * n_int * W + W + 2 * n_int * L
    ops = [(2 * frames * macs, PEAK_FP32_FLOPS), (2 * frames * L * L, PEAK_FP32_FLOPS)]
    return ops, frames * L * (4 + 2) + launches * L * L * 4
