"""The one traffic generator: it reads a mix's parameters
(``bench_port/mixes/<name>.json``) and makes the inputs of a run from its
seed.

Every seed gets the same set of sizes and gaps, in another order: lengths
are the quantiles of the mix's uniform length range, gaps between Poisson
arrivals the quantiles of the exponential distribution, and the seed only
shuffles them and draws the samples.  So runs of different seeds do the
same work, and a seed changes which signal goes where, not how much there
is.

Audio is synthetic speech-like noise made on the device in a few large
calls: white noise whose spectrum falls off above ``tilt_hz`` (power
``1 / (1 + f / tilt_hz) ** (2 * tilt_power)``), under a syllable-rate
envelope that dips ``dip_db`` below its peak, scaled to ``rms``, and with
``"pcm": "int16"`` rounded to 16-bit PCM, as corpora and callers hand
audio over (``rms`` then in units of the 16-bit scale, which the Kaldi
and WeNet recipes compute on).  Its spectral and temporal dynamic range
is what makes a lower precision show in the log features.
"""

import math

import numpy as np
import torch

__all__ = ["exp_gaps", "rng", "shuffled", "synth", "uniform_lengths"]

_MASK63 = (1 << 63) - 1


def rng(seed: int, tag: str) -> np.random.Generator:
    """The host random stream ``tag`` of ``seed``."""
    return np.random.Generator(np.random.PCG64([int(seed) & _MASK63, *tag.encode()]))


def torch_seed(seed: int, tag: str) -> int:
    return int(rng(seed, "torch:" + tag).integers(0, 2**62))


def uniform_lengths(n: int, lo_s: float, hi_s: float, rate: int) -> np.ndarray:
    """``n`` lengths in samples: the quantiles ``(i + 1/2) / n`` of the
    uniform distribution on ``[lo_s, hi_s]`` seconds, ascending."""
    q = (np.arange(n) + 0.5) / n
    return np.round((lo_s + q * (hi_s - lo_s)) * rate).astype(np.int64)


def exp_gaps(n: int, rate_per_s: float) -> np.ndarray:
    """``n`` gaps in seconds between Poisson arrivals at ``rate_per_s``:
    the quantiles ``(i + 1/2) / n`` of the exponential distribution."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate_per_s


def shuffled(values, seed: int, tag: str):
    values = np.asarray(values)
    return values[rng(seed, tag).permutation(len(values))]


def synth(lengths, seed: int, tag: str, audio: dict, rate: int, device, rows_per_call: int = 64):
    """One host signal (float32, or int16 PCM) of each length in ``lengths``, made on
    ``device`` from ``seed`` ``rows_per_call`` rows at a time."""
    lengths = [int(n) for n in lengths]
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, tag))
    out = []
    for lo in range(0, len(lengths), rows_per_call):
        block = lengths[lo: lo + rows_per_call]
        L = max(block)
        x = torch.randn((len(block), L), generator=g, device=device, dtype=torch.float32)
        f = torch.fft.rfftfreq(L, 1.0 / rate, device=device)
        shape = (1.0 + f / float(audio["tilt_hz"])) ** (-float(audio["tilt_power"]))
        x = torch.fft.irfft(torch.fft.rfft(x) * shape, n=L)
        t = torch.arange(L, device=device, dtype=torch.float32) / rate
        phase = torch.rand((len(block), 1), generator=g, device=device) * (2 * math.pi)
        s = 0.5 * (1.0 + torch.sin(2 * math.pi * float(audio["syllable_hz"]) * t + phase))
        x = x * torch.pow(10.0, -float(audio["dip_db"]) / 20.0 * (1.0 - s))
        x = x * (float(audio["rms"]) / x.pow(2).mean(dim=1, keepdim=True).sqrt())
        if audio.get("pcm") == "int16":
            x = torch.clamp(torch.round(x), -32768, 32767).to(torch.int16)
        host = x.cpu().numpy()
        out.extend(np.ascontiguousarray(host[i, :n]) for i, n in enumerate(block))
    return out
