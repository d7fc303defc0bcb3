"""A float32 log by exponent/mantissa split, as the JAX package's.

The counterpart of :mod:`speech_tpu.ops.xmath`.  There, ``log32`` works
around the TPU's hardware float32 log, an approximation whose absolute
error reaches about 1e-4.  CUDA's ``logf`` (and the CPU's libm) is no such
approximation, so the port's own modules keep ``torch.log``; ``log32`` and
``xlog`` are here for code written against the JAX package's names, and
give the same values.

``log32`` splits the exponent and mantissa with integer bit operations,
then takes ``log(m) = 2 * atanh((m - 1) / (m + 1))`` by a short odd
polynomial on ``m`` in ``[sqrt(1/2), sqrt(2))``: about 2 float32 ulps.
Valid for positive *normal* floats.
"""

import numpy as np
import torch

__all__ = ["log32", "xlog"]

# fdlibm-style split of ln 2: the high part has 11 trailing zero mantissa
# bits, so exponent * _LN2_HI is exact for any f32 exponent.  Each constant
# is a float32 value, so an op with a float32 tensor uses it exactly.
_LN2_HI = float(np.float32(6.9313812256e-01))
_LN2_LO = float(np.float32(9.0580006145e-06))
_SQRT2 = float(np.float32(1.4142135624))
# atanh series: log(m) = 2s * (1 + t/3 + t^2/5 + t^3/7 + t^4/9), t = s^2;
# with |s| <= 0.1716 the dropped t^5/11 term is < 7e-10
_C3 = float(np.float32(1 / 3))
_C5 = float(np.float32(1 / 5))
_C7 = float(np.float32(1 / 7))
_C9 = float(np.float32(1 / 9))


def _log32(x: torch.Tensor) -> torch.Tensor:
    bits = x.view(torch.int32)
    e = (bits >> 23) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    # keep the reduced mantissa in [sqrt(1/2), sqrt(2)) so |log m| is small
    # and the halving below is exact
    high = m > _SQRT2
    m = torch.where(high, m * 0.5, m)
    e = (e + high.to(torch.int32)).to(torch.float32)
    s = (m - 1.0) / (m + 1.0)
    t = s * s
    two_s = s + s
    poly = _C3 + t * (_C5 + t * (_C7 + t * _C9))
    log_m = two_s + two_s * t * poly
    return e * _LN2_HI + (log_m + e * _LN2_LO)


class _Log32(torch.autograd.Function):
    """The bit-level split has no gradient, so the exact derivative
    ``1/x`` is attached here, as the JAX package attaches a custom JVP."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _log32(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / x


def log32(x) -> torch.Tensor:
    """Natural log of positive normal float32 values to about 2 ulp;
    differentiable (the derivative is ``1/x``).  A non-tensor goes to a
    CPU tensor."""
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    return _Log32.apply(x)


def xlog(x) -> torch.Tensor:
    """``log`` at the dtype's full accuracy: ``log32`` for float32 inputs,
    ``torch.log`` otherwise (the JAX package's choice)."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float32:
        return log32(x)
    return torch.log(x)
