"""Time variants of the port's base-256 digit kernel (B4,
``double_feats_kernel`` in ``speech_tpu_torch/csrc/double_kernels.cu``)
against it on one GPU, to see where its time goes.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/torch_double_variants.py

Each variant is the kernel's source with one edit, built with the port's
own nvcc flags into ``build/double_kernels_variants/`` and swapped in for the
kernel's library, so every variant runs through the same wrapper.  Each
computes wrong features on purpose, and only its time means anything,
but the first:

- ``scalarload``: an even shift's staged samples loaded 4 bytes at a time,
  as an odd shift's are, in place of 8-byte pair loads (``kPairs``); its
  features must equal the kernel's bit for bit;
- ``nodigits``: a constant x digit fragment in place of the digits, so the
  products, the ring, the folds and the tail remain;
- ``plane0``: every pair's digits from plane 0 (one rounding round): the
  cost of the rounds of the higher planes;
- ``nofold``: no pair's sum but the chunk's last is read or folded, so the
  tensor cores' pipeline never drains between pairs;
- ``halfcopy``: the producer copies half of each stage (half the L2 bytes;
  the rest of the stage is stale);
- ``noload``: the digits made from the sample index in place of the staged
  samples (no shared-memory loads).

The case is the main path's (128 x 15 s, 25 ms frames, 10 ms shift) at
'double' and 'accurate'.  It prints the card's name and power limit, then
per case the median milliseconds of 20 calls of each, by CUDA events, in
the order kernel, variants, variants reversed, kernel.
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

# the producer copies half of each stage: half the L2 bytes
HALF = (
    "mbar_expect(full + slot, kSlotBytes);\n"
    "            bulk_copy(ring + slot * kSlotBytes, src + (long long)q * (kStepBytes / 2), kSlotBytes,",
    "mbar_expect(full + slot, kSlotBytes / 2);\n"
    "            bulk_copy(ring + slot * kSlotBytes, src + (long long)q * (kStepBytes / 2), kSlotBytes / 2,",
)
NODIGITS = (
    "digits(u0, di, a, pq * kStageSteps);",
    "for (int u = 0; u < kStageSteps; ++u) a[u][0] = a[u][1] = a[u][2] = a[u][3] = "
    "0x3f803f80u + (unsigned)(di + u0);",
)
EDITS = {
    "scalarload": [(
        "frame_shift % 2 ? STK_DOUBLE(true, false) : STK_DOUBLE(true, true)",
        "STK_DOUBLE(true, false)",
    )],
    "nodigits": [NODIGITS],
    "plane0": [("digits(u0, di, a, pq * kStageSteps);", "digits(u0, 0, a, pq * kStageSteps);")],
    "nofold": [("      wgmma_wait<0>();\n      fold(pw[ip - 1]);\n", "")],
    "halfcopy": [HALF],
    "noload": [(
        "const float2 v = *reinterpret_cast<const float2*>(xs + i);",
        "const float2 v = make_float2(__int_as_float(0x3e000000 + i), __int_as_float(0x3e000001 + i));",
    )],
}
BANK = {"name": "fbank", "num_filts": 40, "sampling_rate": 16000}
LOG = dict(use_log=True, use_power=False, include_energy=True, log_floor=1e-5)


def case(rng, precision):
    """The B4 call of the main path at ``precision``, on random signals."""
    dev = torch.device("cuda")
    c = STFTFrameComputer(
        dict(BANK), device=dev, frame_length_ms=25, frame_shift_ms=10,
        include_energy=True, dtype="float32", precision=precision,
    )
    n = 15 * 16000
    sig = torch.tensor(rng.randn(128, n).astype(np.float32) * 0.1, device=dev)
    padded = F.pad_signal_full(sig, c.frame_length, c._pad_left)
    kw = dict(num_frames=F.frame_count_np(n, c.frame_length, c.frame_shift),
              frame_length=c.frame_length, frame_shift=c.frame_shift, dft_size=c.dft_size, **LOG)
    if precision == "accurate":
        kw.update(n_x=4, cutoff=3)
    return lambda: K.stft_feats_double(padded, c.params, **kw)


def main():
    if not torch.cuda.is_available():
        sys.exit("this script needs a GPU")
    print(card(), flush=True)
    libs = build_variants("double_kernels", EDITS)
    rng = np.random.RandomState(5)
    names = list(EDITS)
    for precision in ("double", "accurate"):
        fn = case(rng, precision)
        outs, times = {}, {}
        for name in ["kernel"] + names + names[::-1] + ["kernel"]:
            use("double_kernels", libs[name])
            outs.setdefault(name, fn().clone())
            times.setdefault(name, []).append(round(cuda_ms(fn), 3))
        same = torch.equal(outs["kernel"], outs["scalarload"])
        print(f"B4 '{precision}' 128x15s: " + ", ".join(f"{n} {t} ms" for n, t in times.items())
              + f"; scalarload same bits {same}", flush=True)
        if not same:
            sys.exit(f"'{precision}': the sample loads changed the features")
    use("double_kernels", libs["kernel"])


if __name__ == "__main__":
    main()
