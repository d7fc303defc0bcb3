"""The tracked frames over the frames the pitch tracker ran over (its rows
times the frames of the bucket), from ``ShardedExtractor.stats``
(``pitch_valid_frames`` / ``pitch_frames``, the program's counters) over
the window, in percent."""


def read(run):
    c = run.counters
    if not c.get("pitch_frames"):
        return None  # a program that does not count the tracker's frames
    return 100.0 * c["pitch_valid_frames"] / c["pitch_frames"]
