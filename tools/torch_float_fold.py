"""How often the port's float kernel (B1/B3, ``float_feats_kernel``)
should hand its split-pass tensor-core sums to fp32 registers: for each
fold interval, 'highest' on signal rows (B1) and on materialised frames
(B3) against float64 and against the plain version, on fbank banks of 40,
161, 292, 293, 370 and 512 filters (16 kHz, 25 ms, 10 ms, dft 512; narrow
filters expose the tensor cores' truncating fp32 adds), and B1's time on
the main path's 128 x 15 s.

Run on the GPU machine from the repo root (about a minute):

    python3 tools/torch_float_fold.py

The kernel folds after every ring stage (2 k-steps); the variants are
built from edited copies of ``csrc/stft_kernels.cu``
(``tools/torch_variants.py``): ``nofold`` sums all of K on the tensor
cores, ``fold8`` and ``fold4`` fold every 8 and 4 k-steps.  Each line names the card and its power
limit; the kernel is timed first and last.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speech_tpu_torch.compute import STFTFrameComputer  # noqa: E402
from speech_tpu_torch.ops import framing as F  # noqa: E402
from speech_tpu_torch.ops import stft as S  # noqa: E402
from speech_tpu_torch.ops import stft_kernels as K  # noqa: E402
from torch_variants import build_variants, card, cuda_ms, use  # noqa: E402

EDITS = {
    "nofold": [(
        "cudaError_t rc = passes == 1 ? STK_FLOAT(1, false) : STK_FLOAT(3, true);",
        "cudaError_t rc = passes == 1 ? STK_FLOAT(1, false) : STK_FLOAT(3, false);",
    )],
    "fold8": [("constexpr int kFoldSteps = 2;", "constexpr int kFoldSteps = 8;")],
    "fold4": [("constexpr int kFoldSteps = 2;", "constexpr int kFoldSteps = 4;")],
}
LOG = dict(use_power=False, use_log=True, include_energy=True, log_floor=1e-5)


def bank_case(dev, num_filts, x):
    """``(computer, padded rows, call kwargs, float64 features, plain)``."""
    bank = {"name": "fbank", "num_filts": num_filts, "sampling_rate": 16000}
    kw = dict(frame_length_ms=25, frame_shift_ms=10)
    tc = STFTFrameComputer(dict(bank), device=dev, **kw)
    c64 = STFTFrameComputer(dict(bank), device="cpu", dtype="float64", **kw)
    n = x.shape[1]
    mf = F.frame_count_np(n, tc.frame_length, tc.frame_shift)
    padded = F.pad_signal_full(torch.tensor(x, device=dev), tc.frame_length, tc._pad_left)
    call = dict(num_frames=mf, frame_length=tc.frame_length, frame_shift=tc.frame_shift, **LOG)
    fr64 = F.frame_padded(
        F.pad_signal_full(torch.tensor(x.astype(np.float64)), tc.frame_length, tc._pad_left),
        mf, tc.frame_length, tc.frame_shift,
    )
    ref = S.stft_feats_from_frames(fr64, c64.params, dft_size=c64.dft_size, **LOG)
    frames = F.frame_padded(padded, mf, tc.frame_length, tc.frame_shift).contiguous()
    return tc, padded, call, ref.numpy(), K.stft_feats_rows_plain(padded, tc.params, **call), frames


def main():
    if not torch.cuda.is_available():
        sys.exit("this script needs a GPU")
    dev = torch.device("cuda")
    print(card(), flush=True)
    libs = build_variants("stft_kernels", EDITS)
    x = np.random.RandomState(90).randn(3, 9000).astype(np.float32)
    cases = {c: bank_case(dev, c, x) for c in (40, 161, 292, 293, 370, 512)}
    rng = np.random.RandomState(5)
    n = 15 * 16000
    main_c = cases[40][0]
    big = torch.tensor(rng.randn(128, n).astype(np.float32) * 0.1, device=dev)
    bpad = F.pad_signal_full(big, 400, main_c._pad_left)
    bkw = dict(num_frames=F.frame_count_np(n, 400, 160), frame_length=400, frame_shift=160, **LOG)
    for name in ["kernel", *EDITS, "kernel"]:
        use("stft_kernels", libs[name])
        line = [name]
        spec = {k: LOG[k] for k in LOG}
        for num_filts, (tc, padded, call, ref, plain, frames) in cases.items():
            got = K.stft_feats_rows(padded, tc.params, precision="highest", **call)
            fr = K.stft_feats_frames(frames, tc.params, precision="highest", **spec)
            fr_plain = K.stft_feats_frames_plain(frames, tc.params, **spec)
            line.append(
                f"{num_filts} filters: rows vs float64 {np.abs(got.cpu().numpy() - ref).max():.3e}, "
                f"vs plain {(got - plain).abs().max().item():.3e}; frames vs float64 "
                f"{np.abs(fr.cpu().numpy() - ref).max():.3e}, vs plain "
                f"{(fr - fr_plain).abs().max().item():.3e} (plain vs float64 "
                f"{np.abs(fr_plain.cpu().numpy() - ref).max():.3e})"
            )
        ms = cuda_ms(lambda: K.stft_feats_rows(bpad, main_c.params, precision="highest", **bkw))
        line.append(f"128 x 15 s (40 filters) {ms:.3f} ms")
        print("; ".join(line), flush=True)
    errs = {c: np.abs(case[4].cpu().numpy() - case[3]).max() for c, case in cases.items()}
    print("plain (cuBLAS fp32) vs float64: "
          + ", ".join(f"{c} filters {e:.3e}" for c, e in errs.items()), flush=True)


if __name__ == "__main__":
    main()
