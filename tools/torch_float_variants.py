"""Time variants of the port's float kernel (B1/B3, ``float_feats_kernel``
in ``speech_tpu_torch/csrc/stft_kernels.cu``) against it on one GPU.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/torch_float_variants.py

Each variant is the kernel's source with one edit, built with the port's
own nvcc flags into ``build/stft_kernels_variants/`` and swapped in for the
kernel's library, so every variant runs through the same wrapper:

- ``noskew``: the sample buffer without its skew (the launcher finds no
  skew shift better than none); its features must equal the kernel's bit
  for bit, since the skew moves only addresses;
- ``producerwarp``: one producer warp in place of the producer
  warpgroup that hands most of its registers to the consumers by
  ``setmaxnreg`` (40 for it, 232 for each consumer thread); the consumers
  then keep the 168 registers of the launch bound and the split-pass fold
  spills; the same bits;
- ``hionly``: the producer copies only the ``hi`` half of each k-step
  (half the operand bytes read from L2); the ``lo`` products read stale
  shared memory, so only its time means anything.

Cases are the main path (128 x 15 s, 25 ms frames) at a 10 ms and a
10.25 ms shift, for rows (B1) and frames (B3), and 150 ms frames (K 2400)
on 16 x 15 s. Each case runs kernel, noskew, producerwarp, producerwarp,
noskew, kernel (and hionly on the first case) and prints the median
milliseconds of 20 calls of each, by CUDA events, with the card's name and
power limit first.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speech_tpu_torch.compute import STFTFrameComputer  # noqa: E402
from speech_tpu_torch.ops import framing as F  # noqa: E402
from speech_tpu_torch.ops import stft_kernels as K  # noqa: E402
from torch_variants import build_variants, card, cuda_ms, use  # noqa: E402

EDITS = {
    "noskew": [("for (int sh = 5; sh <= 9; ++sh)", "for (int sh = 5; sh <= 4; ++sh)")],
    "hionly": [(
        "constexpr int kBytes = kPasses == 3 ? kStepBytes : kPartBytes;",
        "constexpr int kBytes = kPartBytes;",
    )],
    "producerwarp": [
        ("constexpr int kThreads = kConsumers + 128;       // and a producer warpgroup (one thread works)",
         "constexpr int kThreads = kConsumers + 32;"),
        ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));\n'
         "    if (tid == kConsumers) {",
         "    if (lane == 0) {"),
        ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n', ""),
    ],
}
SAME_BITS = ("noskew", "producerwarp")  # variants that must give the kernel's bits
BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
LOG = dict(use_log=True, use_power=False, include_energy=True, log_floor=1e-5)


def case(rng, batch, length_ms, shift_ms, *, frames, precision="highest"):
    """The wrapper call of one case, on random signals of 15 s."""
    dev = torch.device("cuda")
    c = STFTFrameComputer(
        dict(BANK), device=dev, frame_length_ms=length_ms, frame_shift_ms=shift_ms,
        include_energy=True, dtype="float32", fft_mode="pallas",
    )
    n = 15 * 16000
    sig = torch.tensor(rng.randn(batch, n).astype(np.float32) * 0.1, device=dev)
    padded = F.pad_signal_full(sig, c.frame_length, c._pad_left)
    mf = F.frame_count_np(n, c.frame_length, c.frame_shift)
    if frames:
        fr = F.frame_padded(padded, mf, c.frame_length, c.frame_shift).contiguous()
        return lambda: K.stft_feats_frames(fr, c.params, precision=precision, **LOG)
    kw = dict(num_frames=mf, frame_length=c.frame_length, frame_shift=c.frame_shift,
              precision=precision, **LOG)
    return lambda: K.stft_feats_rows(padded, c.params, **kw)


def main():
    if not torch.cuda.is_available():
        sys.exit("this script needs a GPU")
    print(card(), flush=True)
    libs = build_variants("stft_kernels", EDITS)
    rng = np.random.RandomState(5)
    cases = [
        ("B1 rows K400 shift 160 'highest' 128x15s", case(rng, 128, 25, 10, frames=False), True),
        ("B1 rows K400 shift 160 'default' 128x15s",
         case(rng, 128, 25, 10, frames=False, precision="default"), False),
        ("B1 rows K400 shift 164 'highest' 128x15s", case(rng, 128, 25, 10.25, frames=False), False),
        ("B3 frames K400 shift 164 'highest' 128x15s", case(rng, 128, 25, 10.25, frames=True), False),
        ("B1 rows K2400 shift 160 'highest' 16x15s", case(rng, 16, 150, 10, frames=False), False),
        ("B3 frames K2400 'highest' 16x15s", case(rng, 16, 150, 10, frames=True), False),
    ]
    for label, fn, hionly in cases:
        outs, times = {}, {}
        order = ("kernel", *SAME_BITS, *SAME_BITS[::-1], "kernel")
        for name in order + (("hionly",) if hionly else ()):
            use("stft_kernels", libs[name])
            outs.setdefault(name, fn().clone())
            times.setdefault(name, []).append(cuda_ms(fn))
        same = {v: torch.equal(outs["kernel"], outs[v]) for v in SAME_BITS}
        line = f"{label}: kernel {times['kernel']} ms, " + ", ".join(
            f"{v} {times[v]} ms (same bits {same[v]})" for v in SAME_BITS
        )
        if hionly:
            line += f", hionly {times['hionly']} ms"
        print(line, flush=True)
        for v, ok in same.items():
            if not ok:
                sys.exit(f"{label}: {v} changed the features")
    use("stft_kernels", libs["kernel"])


if __name__ == "__main__":
    main()
