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
   to one card's ``compute_batch`` of the whole batch;
4. serving on a group (``serve``): the ``serve_group`` case (both servers
   on the mesh, rank 0 the front; the 8 kHz float64 computer) at world
   sizes 1 and 4, every served row of world 4 within TOL of world 1, the
   followers' refusals and closes and the isolated failing request held;
   then ``FeatureServer`` at the main config ('double': B2) taking
   ``chip_smoke.py``'s burst (256 ragged utterances of 1-15 s from 4
   threads, ``max_batch`` 64) at world sizes 1 and 4: its audio-s/s (the
   median of 5 bursts after an untimed one), each card's B2 launches (one
   a micro-batch, two for the warm-up) and every row of world 4 within
   TOL_INT8 of world 1.

``python3 tools/torch_multichip.py serving`` runs part 4 alone.
``python3 tools/torch_multichip.py feeds`` needs no card: it times a
stream server's commands (16 feeds of 100 ms) over the relay's gloo group
at world size 4 on the CPU, as pickled objects and as tensors.

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
TOL_INT8 = 2e-6  # the digit tiers' exactness class (tests/test_pallas.py:175)
WORLD = 4
# serve_group's counts and checks, held on their own
SERVE_SKIP = {"follower_checks", "front_checks", "runs", "refusals", "served_stats",
              "isolated_stats", "bad_error"}


def run(world, tmp, cases):
    return W.wait(*W.launch(world, tmp, cases=cases, device="cuda", strict=False))


def compare(one, four, skip=("mesh_data", "slice", "mesh_2d", "placements", "pitch_error")):
    """Failures of the world-4 results against the world-1 results."""
    failures = []
    for key in sorted(set(one) & set(four) - set(skip)):
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


def parallel_checks(tmp, smi):
    """Parts 1-3; their failures."""
    failures = []
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
    return failures


def serving(tmp, smi):
    """Part 4: both servers on a group of cards; its failures."""
    failures = []
    one, four = run(1, tmp, "serve_group"), run(WORLD, tmp, "serve_group")
    print(f"serve_group at world sizes 1 and {WORLD} (NCCL):", flush=True)
    failures += compare(one, four, skip=SERVE_SKIP)
    checks = np.concatenate([four["follower_checks"], four["front_checks"]])
    print(f"  followers' refusals and closes, the front's closes: {checks.tolist()}; the failing "
          f"request failed alone: {bool(four['bad_error'])}, stats {four['isolated_stats']}, "
          f"blocks refused by rank {four['refusals'].tolist()}", flush=True)
    if not (checks == 1).all() or not int(four["bad_error"]):
        failures.append("serve_group checks")
    if list(four["isolated_stats"]) != [8, 1]:
        failures.append(f"serve_group stats {four['isolated_stats']}")
    bench = {w: run(w, tmp, "serve_bench") for w in (1, WORLD)}
    for w, b in bench.items():
        ms = float(np.median(b["bench_ms"]))
        launches = b["bench_launches"].tolist()
        print(f"FeatureServer 'double' on {w} card(s), {int(b['bench_rows_n'].size)} ragged "
              f"utterances of 1-15 s ({float(b['bench_audio_s']):.0f} s of audio) from 4 threads: "
              f"bursts {b['bench_ms'].round(3).tolist()} ms, median {ms:.3f} ms, "
              f"{float(b['bench_audio_s']) / ms * 1e3:.0f} audio-s/s; {int(b['bench_batches'])} "
              f"micro-batches, B2 launches by card {launches} [{smi.splitlines()[0]}]", flush=True)
        if any(n != int(b["bench_batches"]) + 2 for n in launches):
            failures.append(f"serve_bench launches at world {w}: {launches}")
    err = float(np.abs(bench[1]["bench_rows"] - bench[WORLD]["bench_rows"]).max())
    print(f"  served rows, world {WORLD} vs world 1: max abs {err:.3e} (tol {TOL_INT8:g})",
          flush=True)
    if (not np.array_equal(bench[1]["bench_rows_n"], bench[WORLD]["bench_rows_n"])
            or err > TOL_INT8):
        failures.append(f"serve_bench rows: {err}")
    return failures


def feeds(tmp):
    """The relay's transport of stream commands, on the CPU."""
    r = W.wait(*W.launch(WORLD, tmp, cases="relay_feeds", device="cpu", strict=False))
    print(f"a tick's 16 feeds of 1600 float32 samples over the relay's gloo group, world size "
          f"{WORLD} (CPU processes), median ms a message (slowest rank): as objects "
          f"(broadcast_object_list) {float(r['feeds_objects_ms'][0]):.4f}, as tensors "
          f"{float(r['feeds_tensors_ms'][0]):.4f}", flush=True)


def main():
    import torch

    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    if mode not in ("all", "serving", "feeds"):
        sys.exit(f"usage: {sys.argv[0]} [all|serving|feeds]")
    if mode == "feeds":
        with tempfile.TemporaryDirectory() as tmp:
            feeds(tmp)
        return
    if torch.cuda.device_count() < WORLD:
        sys.exit(f"needs {WORLD} GPUs, found {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"cards: {smi}", flush=True)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        if mode == "all":
            failures += parallel_checks(tmp, smi)
        failures += serving(tmp, smi)
    for f in failures:
        print(f"FAIL: {f}", flush=True)
    print("OK" if not failures else f"{len(failures)} failures", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
