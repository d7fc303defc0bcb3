"""The tracked frames over the frames the pitch tracker's Viterbi stepped
over (its rows times the batch's longest tracked row), from
``ShardedExtractor.stats`` (``pitch_valid_frames`` / ``pitch_steps``, the
program's counters) over the window, in percent."""


def read(run):
    c = run.counters
    if not c.get("pitch_steps"):
        return None  # a program that does not count the Viterbi's steps
    return 100.0 * c["pitch_valid_frames"] / c["pitch_steps"]
