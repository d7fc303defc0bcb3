"""The frames the stream's pitch tracker absorbed in live sessions over
the rows times frames its Viterbi loop stepped over (masked rows of
finished or idle slots included), from ``StreamServer.stats``
(``pitch_frames_tracked`` / ``pitch_frames_stepped``, the program's
counters) over the window, in percent."""


def read(run):
    c = run.counters
    if not c.get("pitch_frames_stepped"):
        return None  # a program that does not count the tracker's frames
    return 100.0 * c["pitch_frames_tracked"] / c["pitch_frames_stepped"]
