"""speech_tpu_torch.parallel across four GPUs on NCCL, one process a card.

Run from the repo root on a machine with four cards:

    python3 tools/torch_multichip.py

It starts ``tests/torch_dist_worker.py`` once a rank for each of these runs
(the cases that ``tests/test_torch_parallel.py`` and ``tests/test_torch_nn.py``
run on the CPU over gloo), on ``cuda`` with the NCCL backend:

1. every ``parallel`` case (mesh, halo framing, sharded STFT and SI, the
   extractor on every path, statistics, pitch, the multi-process data
   path; 8 kHz float64 computers) at world sizes 1 and 4, each result of
   the world-4 run held against the world-1 run: integers equal, floats
   within TOL (TOL_PITCH for pitch);
2. the data x filter sharded training step of the STFT frontend on a 2 x 2
   mesh of cards, against the unsharded step on one card within TOL;
3. ``ShardedExtractor`` at ``bench.py``'s main config ('double': B2) on a
   128 x 15 s global batch at world sizes 1 and 4: the ms of a batch (the
   slowest rank), B2 launches, and the gathered features bit for bit equal
   to one card's ``compute_batch`` of the whole batch.

It prints the cards' names and power limits, then one line a check, and
exits non-zero if any check fails.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_worker as W  # noqa: E402

TOL = 1e-8  # float64 results, as tests/test_torch_parallel.py holds them
TOL_PITCH = 1e-4
WORLD = 4


def run(world, tmp, cases):
    return W.wait(*W.launch(world, tmp, cases=cases, device="cuda", strict=False))


def compare(one, four):
    """Failures of the world-4 results against the world-1 results."""
    failures = []
    skip = {"mesh_data", "slice", "mesh_2d", "placements", "pitch_error"}
    for key in sorted(set(one) & set(four) - skip):
        a, b = one[key], four[key]
        if a.shape != b.shape:
            failures.append(f"{key}: shape {b.shape} != {a.shape}")
        elif a.dtype.kind in "iub":
            if not np.array_equal(a, b):
                failures.append(f"{key}: integers differ")
        else:
            tol = TOL_PITCH if key.startswith("pitch") else TOL
            err = float(np.abs(a - b).max()) if a.size else 0.0
            print(f"  {key}: world {WORLD} vs world 1 max abs {err:.3e}", flush=True)
            if err > tol:
                failures.append(f"{key}: {err} > {tol}")
    return failures


def unsharded_step():
    """The STFT frontend's SGD step on one card, whole."""
    import torch

    import speech_tpu_torch as stt

    frontend = stt.nn.STFTFrontend(W.stft_computer(stt, "cuda"), dtype=torch.float64)
    x = torch.tensor(W.inputs()["train"], device="cuda")
    loss = (frontend(x) ** 2).mean()
    loss.backward()
    torch.optim.SGD(frontend.parameters(), lr=W.TRAIN_LR).step()
    return {"train_loss": loss.item(), "train_window": W._np(frontend.window),
            "train_weights": W._np(frontend.weights)}


def main():
    import torch

    if torch.cuda.device_count() < WORLD:
        sys.exit(f"needs {WORLD} GPUs, found {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"cards: {smi}", flush=True)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        one, four = run(1, tmp, "parallel"), run(WORLD, tmp, "parallel")
        print(f"parallel cases at world sizes 1 and {WORLD} (NCCL):", flush=True)
        failures += compare(one, four)
        for key in ("int16_equal", "mesh_error", "halo_error", "si_error", "batch_error",
                    "pitch_error"):
            if key in four and not int(four[key]):
                failures.append(f"{key} at world {WORLD}")
        step = run(WORLD, tmp, "train")
        want = unsharded_step()
        for key in ("train_loss", "train_window", "train_weights"):
            err = float(np.abs(np.asarray(step[key]) - np.asarray(want[key])).max())
            print(f"train step on a 2 x 2 mesh of cards, {key}: max abs {err:.3e} vs one card "
                  f"(tol {TOL:g})", flush=True)
            if err > TOL:
                failures.append(f"{key}: {err}")
        for world in (1, WORLD):
            b = run(world, tmp, "bench")
            ms = float(b["bench_ms"][0])
            print(f"ShardedExtractor 'double' 128 x 15 s on {world} card(s): {ms:.3f} ms a "
                  f"batch (slowest rank), {1920 / (ms / 1e3):.0f} audio-s/s; B2 launches "
                  f"{int(b['bench_launches'][0])}; bitwise equal to one card's compute_batch: "
                  f"{bool(b['bench_equal'][0])} [{smi.splitlines()[0]}]", flush=True)
            if int(b["bench_launches"][0]) != world or not int(b["bench_equal"][0]):
                failures.append(f"bench at world {world}")
    for f in failures:
        print(f"FAIL: {f}", flush=True)
    print("OK" if not failures else f"{len(failures)} failures", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
